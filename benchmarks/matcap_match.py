"""Recover which matcap texture the reference goldens were shaded with.

One render produces the eye-space normals of every hit pixel; the 82
matcap candidates are then swept entirely on the host (sampling is a numpy
gather) against the golden's foreground color distribution.

Usage: python benchmarks/matcap_match.py [--golden car_1]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.ops import camera as cam_lib
from cudaneuralrender.ops import shading
from cudaneuralrender.render import renderer
from cudaneuralrender.utils import image_io

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", default="car_1")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()

    with open(os.path.join(HERE, "golden_cameras.json")) as fh:
        cams = json.load(fh)
    info = cams[args.golden]

    params = cnr.load(f"/root/reference/neuralGeometries/{args.golden}.h5")
    cfg = cnr.RenderConfig(width=args.res, height=args.res, scene="neural_raw",
                           max_steps=args.steps)
    cam = cnr.Camera.from_cli(rx=info["rx"], ry=info["ry"], zoom=info["zoom"])

    @jax.jit
    def normals_and_hits():
        cam_to_world, world_to_cam = cam_lib.view_matrices(cam)
        origin, dirs = cam_lib.generate_rays(cam_to_world, args.res, args.res, cfg.focal)
        from cudaneuralrender.ops import march

        f = renderer.scene_fn(params, cfg, 0.0)
        res = march.sphere_trace(f, origin, dirs, max_steps=cfg.max_steps,
                                 march_eps=cfg.march_eps,
                                 bound_center=cfg.bound_center,
                                 bound_radius=cfg.bound_radius)
        pts = origin + dirs * res.t[:, None]
        n = shading.autodiff_normals(f, pts)
        n_eye = n @ world_to_cam[:3, :3].T
        n_eye = n_eye / jnp.linalg.norm(n_eye, axis=-1, keepdims=True)
        return n_eye, res.hit

    n_eye, hit = (np.asarray(v) for v in normals_and_hits())
    n_eye = n_eye[hit]
    print(f"{args.golden}: {hit.sum()} hit pixels", flush=True)

    # Golden foreground color distribution (image-orientation invariant).
    golden = image_io.load_ppm(f"/root/reference/neuralGeometries/{args.golden}.h5.ppm")
    g_fg = golden[np.any(golden > 10, axis=-1)].astype(np.float32)
    g_mean, g_std = g_fg.mean(axis=0), g_fg.std(axis=0)

    results = []
    for path in sorted(glob.glob("/root/reference/matcaps/*.png")):
        tex = image_io.load_matcap(path)[..., :3] * 255.0
        hm, wm = tex.shape[:2]
        ix = np.clip(((n_eye[:, 0] * 0.5 + 0.5) * (wm - 1)).astype(np.int32), 0, wm - 1)
        iy = np.clip(((n_eye[:, 1] * 0.5 + 0.5) * (hm - 1)).astype(np.int32), 0, hm - 1)
        cols = tex[iy, ix]
        score = (
            np.linalg.norm(cols.mean(axis=0) - g_mean)
            + 0.5 * np.linalg.norm(cols.std(axis=0) - g_std)
        )
        results.append((score, os.path.basename(path)))

    results.sort()
    for score, name in results[:8]:
        print(f"  {score:8.2f}  {name}", flush=True)
    print(f"golden fg mean={g_mean.round(1)} std={g_std.round(1)}")
    print(f"BEST MATCAP for {args.golden}: {results[0][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

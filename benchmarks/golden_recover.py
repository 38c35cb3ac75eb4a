"""Recover the cameras behind the reference's golden renders.

The goldens (`/root/reference/neuralGeometries/*.h5.ppm`, P6 1024²) were
rendered interactively — their (rx, ry, zoom) were never recorded. This
script recovers them by silhouette IoU: coarse grid over rotations at low
resolution, then local refinement over (rx, ry, zoom), trying both vertical
orientations (the reference's render buffer is bottom-up; savePNG's
flip-reverse quirk postdates the goldens — image.cu:84-98).

The recovered cameras feed the golden-parity benchmark (BASELINE configs
1-2): render at 1024² with the recovered camera and report IoU + color
stats vs the golden.

Usage: python benchmarks/golden_recover.py [--golden plane_1] [--res 64]
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.utils import image_io


def golden_mask(name: str, res: int, flip: bool) -> np.ndarray:
    img = image_io.load_ppm(f"/root/reference/neuralGeometries/{name}.h5.ppm")
    if flip:
        img = img[::-1]
    fg = np.any(img > 10, axis=-1)  # non-black
    k = img.shape[0] // res
    return fg.reshape(res, k, res, k).mean(axis=(1, 3)) > 0.5


def iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", default="plane_1")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--start", default=None,
                    help="skip the coarse grid: 'rx,ry,zoom,flip' to refine "
                         "from (use a prior lower-res recovery)")
    ap.add_argument("--fine", type=float, default=None, nargs=2,
                    metavar=("DROT", "DZOOM"),
                    help="extra hill-climb round at this granularity")
    args = ap.parse_args()

    params = cnr.load(f"/root/reference/neuralGeometries/{args.golden}.h5")
    cfg = cnr.RenderConfig(width=args.res, height=args.res, scene="neural_raw",
                           max_steps=args.steps)

    @jax.jit
    def hit_mask(rx, ry, zoom):
        cam = cnr.Camera(rotation_x=rx, rotation_y=ry,
                         translation=jnp.stack([zoom * 0, zoom * 0, -zoom]))
        img = cnr.render_image(params, cam, cfg)
        return img[..., 3] > 0.0

    def mask_for(rx, ry, zoom):
        return np.asarray(hit_mask(jnp.float32(rx), jnp.float32(ry), jnp.float32(zoom)))

    targets = {flip: golden_mask(args.golden, args.res, flip) for flip in (False, True)}

    if args.start:
        parts = args.start.split(",")
        rx0, ry0, z0 = (float(v) for v in parts[:3])
        flip = parts[3].lower() in ("1", "true") if len(parts) > 3 else False
        s0 = iou(mask_for(rx0, ry0, z0), targets[flip])
        best = (s0, (rx0, ry0, z0, flip))
        print(f"starting from {best}", flush=True)
    else:
        t0 = time.time()
        best = (-1.0, None)
        for rx, ry in itertools.product(range(-45, 61, 15), range(0, 360, 15)):
            m = mask_for(rx, ry, 2.0)
            for flip, tgt in targets.items():
                s = iou(m, tgt)
                if s > best[0]:
                    best = (s, (float(rx), float(ry), 2.0, flip))
                    print(f"  coarse best IoU={s:.3f} rx={rx} ry={ry} flip={flip}", flush=True)
        print(f"coarse done in {time.time()-t0:.0f}s: {best}", flush=True)

    # local refinement: rotations +-12 deg at 3-deg steps, zoom 1.4..3.0
    s0, (rx0, ry0, z0, flip) = best
    tgt = targets[flip]
    rounds_spec = ((3.0, 0.2), (1.0, 0.05))
    if args.start:
        rounds_spec = ((1.0, 0.05),)
    if args.fine:
        rounds_spec = rounds_spec + (tuple(args.fine),)
    for rounds, (dr, dz) in enumerate(rounds_spec):
        improved = True
        while improved:
            improved = False
            for drx, dry, dzz in itertools.product((-dr, 0, dr), (-dr, 0, dr), (-dz, 0, dz)):
                if drx == dry == dzz == 0:
                    continue
                cand = (rx0 + drx, ry0 + dry, max(0.5, z0 + dzz))
                s = iou(mask_for(*cand), tgt)
                if s > s0:
                    s0, (rx0, ry0, z0) = s, cand
                    improved = True
        print(f"refine round {rounds}: IoU={s0:.4f} rx={rx0:.1f} ry={ry0:.1f} "
              f"zoom={z0:.2f} flip={flip}", flush=True)

    print(f"RECOVERED {args.golden}: rx={rx0:.1f} ry={ry0:.1f} zoom={z0:.2f} "
          f"flip={flip} IoU={s0:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

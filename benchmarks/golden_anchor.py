"""Anchor the NumPy oracle to the reference binary's committed golden renders.

The framework's correctness chain is framework == NumPy-oracle (per-pixel
allclose, tests/test_oracle_parity.py). Both sides of that chain were written
from the same reading of the CUDA sources, so a shared misunderstanding would
be invisible. The only artifacts produced by the *actual CUDA binary* are the
golden renders `/root/reference/neuralGeometries/*.h5.ppm` (P6 1024^2) — this
script closes the loop by validating ORACLE vs GOLDEN per-pixel.

Obstacles (all recovered here):
  * the goldens' cameras were never recorded, and they were rendered
    interactively — so the full mouse-drag state applies: rotate (left drag,
    main.cpp:318-321), PAN (middle drag, :324-328) and zoom (right drag,
    :330-334), i.e. 5 DOF (rx, ry, tx, ty, tz);
  * the goldens are MATCAP-shaded with an unrecorded texture (plane_1 reddish,
    car_1 pinkish — NOT facing-shaded: their foreground is strongly colored)
    that is NOT among the 82 shipped matcaps (best shipped match, red.png,
    is ~20/255 mean absdiff) — so the texture is RECONSTRUCTED from the
    golden itself (bake_matcap): valid because the golden's color is a pure
    function of our computed eye-normal (within-(nx,ny)-bin std ~4.8/255 —
    which simultaneously validates the normal + eye-transform + UV pipeline
    against the binary; a convention mismatch would scatter the bins);
  * plane_2.h5.ppm is entirely black (broken upstream golden) — excluded.

Phases:
  1. pose  — hill-climb silhouette IoU at 1024^2 over (rx, ry, tx, ty, tz)
             using the staged path (one compiled program, traced camera);
  2. matcap — rank the shipped matcaps (documentation), then bake the actual
             texture from the golden over a stride-2 offset-1 pixel grid;
  3. joint — refine the pose on foreground RGB L2 under the baked matcap;
  4. anchor — NumPy-oracle march of every stride-th golden pixel's EXACT ray
             (reference_oracle.render(stride=...), offset 0 — DISJOINT from
             the bake's training grid), per-pixel compare vs
             golden[::stride, ::stride]; writes benchmarks/golden_anchor.json
             + recovered_matcaps/{name}.png, consumed by
             tests/test_golden_anchor.py.

Usage: python benchmarks/golden_anchor.py [--golden plane_1] [--refine-only]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.ops import camera as cam_lib
from cudaneuralrender.ops import march, shading
from cudaneuralrender.render import renderer
from cudaneuralrender.utils import image_io

import reference_oracle as oracle

HERE = os.path.dirname(os.path.abspath(__file__))
GEOM = "/root/reference/neuralGeometries"
MATCAPS = "/root/reference/matcaps"


def load_golden(name: str, flip: bool) -> np.ndarray:
    """uint8 [1024, 1024, 3]; rows in the framework's row-0-=-bottom order."""
    img = image_io.load_ppm(f"{GEOM}/{name}.h5.ppm")
    if flip:
        img = img[::-1]
    return img


class PoseScorer:
    """Device-side IoU + masked RGB-L2 of a staged render vs the golden.

    Every pose evaluation is one compiled program (traced camera pytree) and
    fetches two/three scalars — no image crosses to the host.
    """

    def __init__(self, params, config, golden_u8: np.ndarray, matcap=None):
        if matcap is not None:
            config = config.replace(shading="matcap")
        self.params, self.config, self.matcap = params, config, matcap
        self.g_rgb = jnp.asarray(golden_u8.astype(np.float32) / 255.0)
        self.g_fg = jnp.asarray(np.any(golden_u8 > 0, axis=-1))

        @jax.jit
        def metrics(img):
            o_fg = img[..., 3] > 0
            inter = (o_fg & self.g_fg).sum()
            union = (o_fg | self.g_fg).sum()
            common = o_fg & self.g_fg
            l2 = ((img[..., :3] - self.g_rgb) ** 2).sum(-1)
            rgb = jnp.where(common, l2, 0.0).sum() / jnp.maximum(common.sum(), 1)
            return inter, union, rgb

        self._metrics = metrics
        self.evals = 0

    def __call__(self, pose) -> tuple[float, float]:
        rx, ry, tx, ty, tz = pose
        cam = cnr.Camera(rotation_x=rx, rotation_y=ry,
                         translation=jnp.asarray([tx, ty, tz], jnp.float32))
        img = cnr.render_sequence(self.params, [cam], self.config, self.matcap)[0]
        inter, union, rgb = (float(v) for v in self._metrics(img))
        self.evals += 1
        return inter / max(union, 1.0), rgb


def hill_climb(score_fn, pose, steps_spec, *, better, score0=None, tag=""):
    """Coordinate-descent over (rx, ry, tx, ty, tz) with shrinking steps."""
    pose = list(pose)
    s0 = score_fn(pose) if score0 is None else score0
    for deltas in steps_spec:
        improved = True
        while improved:
            improved = False
            for axis, d in enumerate(deltas):
                if d == 0.0:
                    continue
                for sgn in (1.0, -1.0):
                    cand = list(pose)
                    cand[axis] += sgn * d
                    s = score_fn(cand)
                    if better(s, s0):
                        pose, s0 = cand, s
                        improved = True
        print(f"  {tag} step {deltas}: score={s0} pose="
              f"({pose[0]:.2f},{pose[1]:.2f},{pose[2]:.3f},{pose[3]:.3f},{pose[4]:.3f})",
              flush=True)
    return pose, s0


def eye_normals(params, config, pose):
    """[N,3] eye-space normals + hit mask via the dense march (one shot)."""
    rx, ry, tx, ty, tz = pose
    cam = cnr.Camera(rotation_x=rx, rotation_y=ry, translation=(tx, ty, tz))

    @jax.jit
    def run():
        cam_to_world, world_to_cam = cam_lib.view_matrices(cam)
        origin, dirs = cam_lib.generate_rays(
            cam_to_world, config.height, config.width, config.focal)
        f = renderer.scene_fn(params, config, 0.0)
        res = march.sphere_trace(
            f, origin, dirs, max_steps=config.max_steps,
            march_eps=config.march_eps, bound_center=config.bound_center,
            bound_radius=config.bound_radius)
        pts = origin + dirs * res.t[:, None]
        n = shading.autodiff_normals(f, pts)
        ne = n @ world_to_cam[:3, :3].T
        ne = ne / jnp.linalg.norm(ne, axis=-1, keepdims=True)
        return ne, res.hit

    ne, hit = run()
    return np.asarray(ne), np.asarray(hit)


def sweep_matcaps(ne, hit, golden_u8):
    """Per-pixel L2 of every shipped matcap vs the golden on hit∩fg."""
    g = golden_u8.reshape(-1, 3).astype(np.float32)
    fg = np.any(golden_u8 > 0, axis=-1).reshape(-1)
    sel = hit & fg
    ne_s, g_s = ne[sel], g[sel]
    results = []
    import glob
    for path in sorted(glob.glob(f"{MATCAPS}/*.png")):
        tex = image_io.load_matcap(path)[..., :3] * 255.0
        hm, wm = tex.shape[:2]
        ix = np.clip(((ne_s[:, 0] * 0.5 + 0.5) * (wm - 1)).astype(np.int32), 0, wm - 1)
        iy = np.clip(((ne_s[:, 1] * 0.5 + 0.5) * (hm - 1)).astype(np.int32), 0, hm - 1)
        err = float(np.mean(np.sum((tex[iy, ix] - g_s) ** 2, axis=-1)))
        results.append((err, path))
    results.sort()
    return results


def oracle_march_normals(params, pose, stride, offset, max_steps):
    """March every (offset + k*stride)-th golden pixel's exact ray with the
    NumPy oracle; returns (eye_normals [N,3] — zeros on misses, hit [N],
    grid_hw). Shared by the matcap bake and diagnostics."""
    rx, ry, tx, ty, tz = pose
    cam_to_world, world_to_cam = oracle.view_matrices(rx, ry, (tx, ty, tz))
    scene_eval = oracle.make_scene_eval("neural_raw", params, 0.0, 3)
    origin, dirs = oracle.generate_rays(cam_to_world, 1024, 1024, 2.0)
    grid = dirs.reshape(1024, 1024, 3)[offset::stride, offset::stride]
    hw = grid.shape[:2]
    dirs = grid.reshape(-1, 3)
    tnear, tfar, bhit = oracle.intersect_sphere(origin, dirs, radius=1.2)
    tnear = np.maximum(tnear, np.float32(0))
    pts = (origin[None, :] + dirs * tnear[:, None]).astype(np.float32)
    budget = np.where(bhit, tfar, np.float32(0))
    active = bhit.copy()
    conv = np.zeros(len(dirs), bool)
    for _ in range(max_steps):
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        d = scene_eval(pts[idx])
        b = budget[idx] - d
        budget[idx] = b
        miss = b <= 0
        moved = ~miss
        mi = idx[moved]
        pts[mi] = pts[mi] + dirs[mi] * d[moved][:, None]
        cn = moved & (d < np.float32(1e-6))
        conv[idx[cn]] = True
        active[idx] = moved & ~cn
    hit_idx = np.nonzero(conv)[0]
    n = oracle.tetrahedron_normals(scene_eval, pts[hit_idx])
    ne = (n @ world_to_cam[:3, :3].T).astype(np.float32)
    ne = ne / np.linalg.norm(ne, axis=-1, keepdims=True)
    ne_map = np.zeros((len(dirs), 3), np.float32)
    ne_map[hit_idx] = ne
    return ne_map, conv, hw


def bake_matcap(params, pose, golden_u8, *, res=128, stride=2, offset=1,
                max_steps=2000):
    """Reconstruct the golden's matcap texture from the golden itself.

    The golden's foreground color is a pure function of the eye-space
    normal's (nx, ny) (measured within-bin std ~4.8/255 under OUR normal +
    eye-transform + UV convention — which is itself the strongest possible
    validation of those pipelines against the binary), but the actual
    texture is NOT among the 82 shipped matcaps (best per-pixel match,
    red.png, is 20/255 off on average). So bake it: march an offset pixel
    grid DISJOINT from the anchor test grid (offset 1 stride 2 vs the
    test's offset 0 stride 4 — a train/test split that keeps the per-pixel
    anchor honest), bin (nx, ny) -> mean golden color, fill unobserved
    texels by nearest-neighbor dilation.

    Returns (tex [res, res, 3] float in [0,1], observed-mask [res, res]).
    """
    ne, hit, hw = oracle_march_normals(params, pose, stride, offset, max_steps)
    g = golden_u8[offset::stride, offset::stride].reshape(-1, 3).astype(np.float32)
    g_fg = np.any(golden_u8[offset::stride, offset::stride] > 0, axis=-1).reshape(-1)
    sel = hit & g_fg
    ne_s, g_s = ne[sel], g[sel] / 255.0

    ix = np.clip(((ne_s[:, 0] * 0.5 + 0.5) * (res - 1)).astype(np.int32), 0, res - 1)
    iy = np.clip(((ne_s[:, 1] * 0.5 + 0.5) * (res - 1)).astype(np.int32), 0, res - 1)
    acc = np.zeros((res, res, 3), np.float64)
    cnt = np.zeros((res, res), np.int64)
    np.add.at(acc, (iy, ix), g_s)
    np.add.at(cnt, (iy, ix), 1)
    observed = cnt > 0
    tex = np.zeros((res, res, 3), np.float32)
    tex[observed] = (acc[observed] / cnt[observed, None]).astype(np.float32)

    # Nearest-ish hole fill: iterative 4-neighbor dilation (hit normals only
    # cover the nz>0 hemisphere disc; corners/unseen angles get the nearest
    # observed color so stray lookups stay sane).
    filled = observed.copy()
    while not filled.all():
        grew = False
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            src = np.roll(filled, (dy, dx), (0, 1))
            srct = np.roll(tex, (dy, dx), (0, 1))
            if dy == 1:
                src[0, :] = False
            if dy == -1:
                src[-1, :] = False
            if dx == 1:
                src[:, 0] = False
            if dx == -1:
                src[:, -1] = False
            new = src & ~filled
            if new.any():
                tex[new] = srct[new]
                filled |= new
                grew = True
        if not grew:
            break
    return tex, observed


def oracle_anchor(name, pose, matcap, golden_u8, stride, max_steps):
    """Phase 4: the oracle marches golden[::stride, ::stride]'s exact rays.
    ``matcap`` is a float [H,W,3|4] texture in [0,1] (typically the baked
    reconstruction)."""
    params = cnr.load(f"{GEOM}/{name}.h5")
    rx, ry, tx, ty, tz = pose
    t0 = time.time()
    out = oracle.render(
        params, 1024, 1024, rotation_x=rx, rotation_y=ry,
        translation=(tx, ty, tz), scene="neural_raw", shading="matcap",
        matcap=matcap, max_steps=max_steps, stride=stride)
    dt = time.time() - t0
    o_rgb = (np.clip(out[..., :3], 0, 1) * 255.0).astype(np.int32)  # truncate, rgbaFloatToInt
    o_fg = out[..., 3] > 0
    g = golden_u8[::stride, ::stride].astype(np.int32)
    g_fg = np.any(g > 0, axis=-1)

    sil_agree = float((o_fg == g_fg).mean())
    common = o_fg & g_fg
    diff = np.abs(o_rgb - g).max(axis=-1)
    d_common = diff[common]
    stats = {
        "stride": stride,
        "max_steps": max_steps,
        "pixels": int(o_fg.size),
        "silhouette_agreement": round(sil_agree, 5),
        "common_fg": int(common.sum()),
        "rgb_frac_within_4": round(float((d_common <= 4).mean()), 5),
        "rgb_frac_within_8": round(float((d_common <= 8).mean()), 5),
        "rgb_frac_within_16": round(float((d_common <= 16).mean()), 5),
        "rgb_mean_absdiff": round(float(d_common.mean()), 3),
        "oracle_seconds": round(dt, 1),
    }
    return stats


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", default="plane_1", choices=["plane_1", "car_1"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--oracle-steps", type=int, default=1200)
    ap.add_argument("--refine-only", action="store_true",
                    help="start from golden_anchor.json instead of "
                         "golden_cameras.json")
    ap.add_argument("--skip-oracle", action="store_true")
    args = ap.parse_args()
    name = args.golden

    with open(os.path.join(HERE, "golden_cameras.json")) as fh:
        cam0 = json.load(fh)[name]
    out_path = os.path.join(HERE, "golden_anchor.json")
    anchors = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            anchors = json.load(fh)

    golden = load_golden(name, cam0["flip"])
    params = cnr.load(f"{GEOM}/{name}.h5")
    config = cnr.RenderConfig(width=1024, height=1024, scene="neural_raw",
                              max_steps=args.steps, march_impl="staged")

    if args.refine_only and name in anchors:
        pose = anchors[name]["pose"]
        pose = [pose["rx"], pose["ry"], pose["tx"], pose["ty"], pose["tz"]]
    else:
        pose = [cam0["rx"], cam0["ry"], 0.0, 0.0, -cam0["zoom"]]

        # ---- phase 1: silhouette IoU over 5 DOF at full resolution
        sil = PoseScorer(params, config, golden)
        iou0 = sil(pose)[0]
        print(f"[{name}] start IoU@1024={iou0:.4f} pose={pose}", flush=True)
        pose, best = hill_climb(
            lambda p: sil(p)[0], pose,
            steps_spec=[(2.0, 2.0, 0.05, 0.05, 0.10),
                        (0.7, 0.7, 0.02, 0.02, 0.04),
                        (0.25, 0.25, 0.008, 0.008, 0.015),
                        (0.1, 0.1, 0.003, 0.003, 0.006)],
            better=lambda a, b: a > b, score0=iou0, tag="IoU")
        print(f"[{name}] pose after silhouette: IoU={best:.4f} "
              f"({sil.evals} evals)", flush=True)

    # ---- phase 2: nearest shipped matcap (documentation only — none of
    # the 82 shipped textures reproduces the golden per-pixel; best match
    # red.png is ~20/255 mean absdiff) + matcap RECONSTRUCTION from the
    # golden itself (bake_matcap docstring).
    ncfg = config.replace(march_impl="while")
    ne, hit = eye_normals(params, ncfg, pose)
    ranked = sweep_matcaps(ne, hit, golden)
    for err, path in ranked[:4]:
        print(f"  matcap {err:9.1f}  {os.path.basename(path)}", flush=True)
    nearest_shipped = os.path.basename(ranked[0][1])
    print(f"[{name}] nearest shipped matcap = {nearest_shipped}; baking the "
          "actual texture from the golden", flush=True)
    tex, observed = bake_matcap(params, pose, golden)
    print(f"[{name}] baked {tex.shape[0]}^2 matcap "
          f"({observed.mean()*100:.1f}% texels observed)", flush=True)
    matcap_dir = os.path.join(HERE, "recovered_matcaps")
    os.makedirs(matcap_dir, exist_ok=True)
    matcap_path = os.path.join(matcap_dir, f"{name}.png")

    # ---- phase 3: joint refine on per-pixel RGB L2 (IoU guarded)
    matcap = jnp.asarray(tex)
    rgb_scorer = PoseScorer(params, config, golden, matcap)

    def score(p):
        iou_v, rgb_v = rgb_scorer(p)
        # L2 in [0,3]-ish; silhouette loss keeps pose from trading edges for color
        return rgb_v + 2.0 * (1.0 - iou_v)

    s0 = score(pose)
    pose, s_fin = hill_climb(
        score, pose,
        steps_spec=[(0.3, 0.3, 0.01, 0.01, 0.02),
                    (0.1, 0.1, 0.004, 0.004, 0.008),
                    (0.04, 0.04, 0.0015, 0.0015, 0.003)],
        better=lambda a, b: a < b, score0=s0, tag="RGB")
    iou_fin, rgb_fin = rgb_scorer(pose)
    print(f"[{name}] final: IoU={iou_fin:.4f} fgRGB_L2={rgb_fin:.5f} "
          f"({rgb_scorer.evals} evals)", flush=True)

    # Re-bake on the refined pose and commit the texture (uint8 PNG).
    tex, observed = bake_matcap(params, pose, golden)
    image_io.save_png(
        matcap_path, (np.clip(tex, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    print(f"[{name}] wrote {matcap_path}", flush=True)

    rec = {
        "pose": {"rx": round(pose[0], 3), "ry": round(pose[1], 3),
                 "tx": round(pose[2], 4), "ty": round(pose[3], 4),
                 "tz": round(pose[4], 4)},
        "flip": cam0["flip"],
        "matcap": os.path.relpath(matcap_path, HERE),
        "nearest_shipped_matcap": [
            [round(e, 1), os.path.basename(p)] for e, p in ranked[:3]],
        "framework_iou_1024": round(iou_fin, 5),
        "framework_fg_rgb_l2": round(rgb_fin, 6),
        "baked_texels_observed": round(float(observed.mean()), 4),
    }

    # ---- phase 4: oracle-vs-golden per-pixel anchor (test pixels are the
    # stride-4 offset-0 grid — DISJOINT from the bake's stride-2 offset-1
    # training grid).
    if not args.skip_oracle:
        stats = oracle_anchor(name, pose, tex, golden,
                              args.stride, args.oracle_steps)
        print(f"[{name}] ORACLE vs GOLDEN: {json.dumps(stats)}", flush=True)
        rec["oracle_vs_golden"] = stats

    anchors[name] = rec
    anchors["_comment"] = (
        "Recovered interactive camera state (rx ry tx ty tz; 5-DOF incl. "
        "middle-drag pan) and matcap for the reference binary's golden "
        "renders, plus per-pixel ORACLE-vs-GOLDEN agreement at every "
        "stride-th pixel of the 1024^2 frame. plane_2.h5.ppm is all-black "
        "upstream and cannot anchor anything. Produced by golden_anchor.py; "
        "consumed by tests/test_golden_anchor.py.")
    with open(out_path, "w") as fh:
        json.dump(anchors, fh, indent=1)
    print(f"wrote {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Decompose the staged 1080p render into per-component costs on the device.

Prints a timing line per component (median of --reps post-warmup execs,
scalar-fetch synced). Run in one process so remote compiles amortize.
"""
from __future__ import annotations

import argparse
import sys
import time

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.models import mlp
from cudaneuralrender.ops import camera as camera_lib
from cudaneuralrender.ops import march
from cudaneuralrender.render import renderer


def timed(name, fn, *args, reps=5, **kw):
    fn(*args, **kw).block_until_ready()
    s = float(jnp.sum(fn(*args, **kw)))  # honest sync
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(jnp.sum(fn(*args, **kw)))
        ts.append(time.perf_counter() - t0)
    print(f"{name:42s}: {np.median(ts)*1e3:9.2f} ms  (min {np.min(ts)*1e3:9.2f})  sum={s:.3f}", flush=True)
    return np.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    w, h = (int(v) for v in args.res.split("x"))
    n = w * h

    params = cnr.load("examples/assets/csg_demo.npz")
    cfg = cnr.RenderConfig(width=w, height=h, scene="neural_raw", max_steps=6000, march_impl="staged")
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    cam_to_world, world_to_cam = camera_lib.view_matrices(cam)
    origin, dirs = camera_lib.generate_rays(cam_to_world, h, w, cfg.focal)
    pts = origin + dirs * 0.5
    print(f"n_rays={n}", flush=True)

    # --- single MLP eval over all rays, XLA chain, HIGHEST vs DEFAULT
    f_hi = jax.jit(lambda p: mlp.apply_scalar(params, p, precision=jax.lax.Precision.HIGHEST))
    f_lo = jax.jit(lambda p: mlp.apply_scalar(params, p, precision=jax.lax.Precision.DEFAULT))
    timed("mlp XLA HIGHEST 1 eval (all rays)", f_hi, pts, reps=args.reps)
    timed("mlp XLA DEFAULT 1 eval (all rays)", f_lo, pts, reps=args.reps)

    # --- 16 dense march steps (mixed coarse phase analogue)
    def dense16(o, d, prec):
        f = renderer.scene_fn(params, cfg, 0.0, precision=prec)
        st = march.init_state(o, d, cfg.bound_center, cfg.bound_radius)
        st = march.march_stage(f, o, d, st, num_steps=16, max_steps=6000, march_eps=cfg.coarse_eps)
        return st.t
    d16_lo = jax.jit(lambda o, d: dense16(o, d, jax.lax.Precision.DEFAULT))
    d16_hi = jax.jit(lambda o, d: dense16(o, d, jax.lax.Precision.HIGHEST))
    timed("16 dense steps DEFAULT", d16_lo, origin, dirs, reps=args.reps)
    timed("16 dense steps HIGHEST", d16_hi, origin, dirs, reps=args.reps)

    # --- full scheduled march (the real program)
    sched = jax.jit(lambda o, d: renderer._scheduled_march.__wrapped__(params, cam_to_world, o, d, cfg, jnp.float32(0.0))[0].t)
    timed("full _scheduled_march", sched, origin, dirs, reps=args.reps)

    # --- shading (packed-bucket) incl. final image-order restore sort
    pr, steps, _, _, _ = renderer._scheduled_march(params, cam_to_world, origin, dirs, cfg, jnp.float32(0.0))
    shade = jax.jit(lambda p, s: renderer._shade_packed(params, origin, cam_to_world, p, s, world_to_cam, cfg, None, jnp.float32(0.0))[0])
    timed("packed shading + restore", shade, pr, steps, reps=args.reps)

    # --- end to end
    e2e = lambda c: renderer.render_staged(params, c, cfg)
    timed("render_staged end-to-end", e2e, cam, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render-path benchmark matrix: dense, staged with the march kernel, and
staged on the XLA march (coarse_pallas=refine_pallas=False).

Every sample syncs via a scalar fetch, and the first (compiling) execution
is excluded from stats.

Usage: python benchmarks/render_bench.py [--res 1920x1080] [--frames 4]
"""
from __future__ import annotations

import argparse
import sys
import time

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import numpy as np

import cudaneuralrender as cnr


def sync(x) -> float:
    """Force completion and return a checksum scalar."""
    return float(x.sum())


def time_path(render, cameras, warmup: int = 1) -> tuple:
    for i in range(warmup):
        sync(render(cameras[i % len(cameras)]))
    times = []
    for cam in cameras:
        t0 = time.perf_counter()
        s = sync(render(cam))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(np.min(times)), s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--model", default="examples/assets/csg_demo.npz")
    ap.add_argument("--paths", default="dense,staged,staged-xla")
    args = ap.parse_args()

    w, h = (int(v) for v in args.res.split("x"))
    params = cnr.load(args.model)
    cameras = [cnr.Camera(rotation_y=20.0 * i, rotation_x=10.0) for i in range(args.frames)]
    rays = w * h

    base = cnr.RenderConfig(width=w, height=h, scene="neural_raw", max_steps=args.steps)
    variants = {
        "dense": (cnr.render_image, base),
        "staged": (cnr.render_staged, base.replace(march_impl="staged")),
        "staged-xla": (
            cnr.render_staged,
            base.replace(march_impl="staged", coarse_pallas=False,
                         refine_pallas=False),
        ),
    }

    results = {}
    for name in args.paths.split(","):
        fn, cfg = variants[name]
        t0 = time.perf_counter()
        med, best, checksum = time_path(lambda c: fn(params, c, cfg), cameras)
        results[name] = (med, best)
        print(
            f"{name:14s}: median {med*1e3:8.1f} ms/frame  "
            f"({rays/med/1e6:7.1f} Mrays/s)  best {best*1e3:8.1f} ms  "
            f"[total incl. compile {time.perf_counter()-t0:.0f}s, sum={checksum:.1f}]",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched multi-geometry rendering benchmark (BASELINE config 3).

Stacks every same-architecture geometry in neuralGeometries/ and renders
them in ONE vmapped program vs. sequentially, reporting the batching
speedup. The reference renders one geometry per process; this is the
expert-parallel analogue (SURVEY.md §2.4).

Usage: python benchmarks/multigeom_bench.py [--res 512] [--steps 1000]
"""
from __future__ import annotations

import argparse
import glob
import sys
import time

import os as _os

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.models import mlp
from cudaneuralrender.render import multigeom


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=None, help="save a contact sheet PNG here")
    args = ap.parse_args()

    paths = sorted(glob.glob("/root/reference/neuralGeometries/*.h5"))
    all_params = []
    for p in paths:
        try:
            params = cnr.load(p)
            all_params.append((p, params))
        except Exception as e:  # noqa: BLE001 — skip malformed files
            print(f"skip {p}: {e}")
    archs = {}
    for p, params in all_params:
        archs.setdefault(mlp.layer_sizes(params), []).append((p, params))
    arch, group = max(archs.items(), key=lambda kv: len(kv[1]))
    print(f"{len(group)} geometries with architecture {arch}")

    stacked = multigeom.stack_params([params for _, params in group])
    cfg = cnr.RenderConfig(width=args.res, height=args.res, scene="neural_raw",
                           max_steps=args.steps)
    cam = cnr.Camera(rotation_y=30.0, rotation_x=10.0)

    def sync(x):
        return float(jnp.sum(x))

    # Batched: one program renders every geometry.
    sync(multigeom.render_batch(stacked, cam, cfg))  # compile
    t0 = time.perf_counter()
    imgs = multigeom.render_batch(stacked, cam, cfg)
    sync(imgs)
    t_batch = time.perf_counter() - t0

    # Sequential: one geometry at a time through the same single-geom program.
    sync(cnr.render_image(group[0][1], cam, cfg))  # compile
    t0 = time.perf_counter()
    for _, params in group:
        sync(cnr.render_image(params, cam, cfg))
    t_seq = time.perf_counter() - t0

    # Pipelined staged: per-geometry staged programs, one drain (the fast
    # path; vmapped-dense only wins when the dense march under-utilizes the
    # chip, which the staged kernel path no longer does).
    cfg_staged = cfg.replace(march_impl="staged")

    def sync_list(xs):
        return float(jnp.stack([jnp.sum(x) for x in xs]).sum())

    sync_list(multigeom.render_batch_staged(
        [params for _, params in group][:1], cam, cfg_staged))  # compile
    t0 = time.perf_counter()
    outs = multigeom.render_batch_staged(
        [params for _, params in group], cam, cfg_staged)
    sync_list(outs)
    t_staged = time.perf_counter() - t0

    g = len(group)
    print(f"batched (vmap dense):    {t_batch*1e3:8.1f} ms for {g} geometries "
          f"({g*args.res*args.res/t_batch/1e6:.1f} Mrays/s aggregate)")
    print(f"sequential (dense):      {t_seq*1e3:8.1f} ms")
    print(f"pipelined staged:        {t_staged*1e3:8.1f} ms "
          f"({g*args.res*args.res/t_staged/1e6:.1f} Mrays/s aggregate, "
          f"{t_batch/t_staged:.1f}x over vmap dense)")

    if args.out:
        from cudaneuralrender.utils import image_io

        sheet = multigeom.contact_sheet(imgs)
        image_io.save_png(args.out, image_io.to_uint8_image(np.asarray(sheet)))
        print(f"contact sheet: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

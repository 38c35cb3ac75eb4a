"""Batched-inference benchmark + correctness harness.

Equivalent of the reference's `simpleInfer` binary
(src/simpleInfer.cpp:81-194):

  * ``single``  — N sequential single-point inferences, per-call latency
    (singleTest, simpleInfer.cpp:81-110; prints tanh(y) for the zero point
    like the reference's eyeball check at :109).
  * ``batch``   — one B-point batch (default 1,000,000 like main at :186-193)
    through the 9-layer chain, wall-clock ms, plus the reference's
    correctness check: identical inputs must produce bit-identical outputs
    (batchTest verification, simpleInfer.cpp:135-146).
  * ``sweep``   — batch-size sweep to expose the points/s roofline.
  * ``stream``  — bounded-memory chunked pipeline over a giant point set
    (default 16M): fixed-size chunks stream host->device->compute->host with
    a small in-flight window, so device memory stays O(window * chunk)
    regardless of total size. This implements the reference's admitted TODO:
    streamedBatchedTest's body is a copy of batchTest
    (src/simpleInfer.cpp:149-184) and the render loop carries a memory TODO
    (src/volumeRender_kernel.cu:660). Target: within ~10% of the one-batch
    points/s at 16x the size.

Usage: python benchmarks/infer_bench.py [--batch 1000000] [--model ...]
       python benchmarks/infer_bench.py --mode stream [--total 16000000]
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


def _sync(x) -> float:
    return float(jnp.sum(x))


def single_test(params, n: int = 100) -> None:
    f = jax.jit(lambda p: mlp.apply_scalar(params, p))
    x = jnp.zeros((1, 3), jnp.float32)
    y = f(x)  # compile
    _sync(y)
    t0 = time.perf_counter()
    for _ in range(n):
        _sync(f(x))
    dt = (time.perf_counter() - t0) / n
    print(f"single inference: {dt*1e3:.3f} ms/call over {n} calls "
          f"(round-trip incl. host sync); tanh(y[0]) = {float(jnp.tanh(y[0])):.6f}",
          flush=True)


def batch_test(params, batch: int, verify: bool = True) -> float:
    f = jax.jit(lambda x: mlp.apply_scalar(params, x))
    x = jnp.zeros((batch, 3), jnp.float32)
    y = f(x)
    _sync(y)  # compile + warm
    t0 = time.perf_counter()
    y = f(x)
    _sync(y)
    dt = time.perf_counter() - t0
    print(f"batch inference: {batch} points in {dt*1e3:.2f} ms "
          f"({batch/dt/1e6:.1f} Mpoints/s)", flush=True)
    if verify:
        vals = np.asarray(y)
        ok = bool(np.all(vals == vals[0]))
        print(f"verification ({'PASS' if ok else 'FAIL'}): all {batch} outputs "
              f"{'bit-identical' if ok else 'DIFFER'}; y = {vals[0]:.6f}", flush=True)
        if not ok:
            raise SystemExit(1)
    return dt


def sweep(params) -> None:
    for b in (1 << 14, 1 << 17, 1 << 20, 1 << 22):
        batch_test(params, b, verify=False)


def stream_test(params, total: int, chunk: int, window: int = 4,
                verify: bool = True) -> None:
    """Bounded-memory streaming inference.

    JAX async dispatch is the pipeline: each chunk's H2D upload, chain
    compute, and D2H readback are queued without blocking, and the host
    only drains the OLDEST in-flight chunk once ``window`` are pending —
    upload/compute/readback of successive chunks overlap on device, while
    device footprint stays <= window * (chunk_in + chunk_out) bytes
    (~<=64 MB at the defaults vs ~16x that for a monolithic 16M batch
    with intermediates).
    """
    from collections import deque

    n_chunks = (total + chunk - 1) // chunk
    f = jax.jit(lambda x: mlp.apply_scalar(params, x))
    host_x = np.zeros((chunk, 3), np.float32)

    y = f(jax.device_put(host_x))
    _sync(y)  # compile + warm

    checks = []
    t0 = time.perf_counter()
    pending: deque = deque()
    for _ in range(n_chunks):
        xd = jax.device_put(host_x)          # H2D (async)
        y = f(xd)                            # compute (async)
        try:
            y.copy_to_host_async()           # D2H (async)
        except AttributeError:
            pass
        pending.append(y)
        if len(pending) > window:
            out = np.asarray(pending.popleft())  # drain oldest only
            checks.append((out[0], out.min(), out.max()))
    while pending:
        out = np.asarray(pending.popleft())
        checks.append((out[0], out.min(), out.max()))
    dt = time.perf_counter() - t0
    pts_per_s = n_chunks * chunk / dt

    one = batch_test(params, chunk, verify=False)
    ratio = (chunk / one) / pts_per_s
    print(f"streamed inference: {n_chunks * chunk} points in {dt*1e3:.1f} ms "
          f"({pts_per_s/1e6:.1f} Mpoints/s; one-batch rate x{1/ratio:.2f}, "
          f"window={window}, chunk={chunk})", flush=True)
    if verify:
        vals = np.asarray(checks, np.float32)
        ok = bool(np.all(vals == vals[0, 0]))
        print(f"verification ({'PASS' if ok else 'FAIL'}): all chunks "
              f"{'bit-identical' if ok else 'DIFFER'}", flush=True)
        if not ok:
            raise SystemExit(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="examples/assets/csg_demo.npz")
    ap.add_argument("--batch", type=int, default=1_000_000)
    ap.add_argument("--total", type=int, default=16_000_000,
                    help="total points for --mode stream")
    ap.add_argument("--window", type=int, default=4,
                    help="in-flight chunks for --mode stream")
    ap.add_argument("--mode", choices=("single", "batch", "sweep", "stream", "all"),
                    default="all")
    args = ap.parse_args()

    params = cnr.load(args.model)
    print(f"model: {args.model} ({mlp.num_params(params)} params)", flush=True)
    if args.mode in ("single", "all"):
        single_test(params)
    if args.mode in ("batch", "all"):
        batch_test(params, args.batch, verify=True)
    if args.mode == "sweep":
        sweep(params)
    if args.mode == "stream":
        stream_test(params, args.total, args.batch, window=args.window)
    return 0


if __name__ == "__main__":
    sys.exit(main())

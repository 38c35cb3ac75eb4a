"""The sphere-trace march as one GPU kernel (Pallas, Triton route).

The reference runs every march step as separate launches — a thrust scan to
compact the active rays, a gather, nine CUTLASS GEMMs with fused bias+ReLU,
the step update — and reads the active count back to the host each step
(volumeRender_kernel.cu:549-576, denseLayer.cu:126-176). Under XLA the
staged path pays the same shape of cost: each ``while_loop`` iteration is
several launches plus a predicate read back to the host, and every layer
round-trips the [N, 32] activations through device memory.

Here one program marches a block of ``block`` rays to the end of the rung:

  * rays are rows: the activations are [block, H] and each hidden layer is
    one ``[block, H] @ [H, H]`` product on the tensor cores;
  * the input layer (3 or 4 wide) is three or four exact f32 FMAs per unit
    and the 1-wide head is a row reduction — padding either to Triton's
    16-wide minimum dot would waste most of a tensor-core product and
    round the coordinates to TF32;
  * the per-ray state (t, budget, flags) stays in registers for the whole
    loop, and the ~36 KB of weights of the 32-wide net are read through L1;
  * a block exits as soon as its own rays are dry — per-block early exit
    is the compaction, with no scan, gather or host sync.

Precision of the hidden-layer products (Triton lowering): DEFAULT and HIGH
run in TF32; HIGHEST runs ``HIGHEST_ALGORITHM`` (see PERF.md for the SDF
error of each, measured on the card).

Routes (``interpret_mode``): interpret mode on the CPU backend (tests),
the Triton route on the GPU, an error anywhere else.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..models.mlp import MLPParams
from ..ops import march
from ..utils.config import RenderConfig
from . import scenes

# Widest (padded) layer the kernel takes. A wider net's [H, H] f32 weight
# tile and [block, H] activations outgrow what one block keeps on chip
# (256-wide: 256 KB per layer against 227 KB of shared memory), so such
# nets march on the XLA path, where cuBLAS takes the wide products.
MAX_WIDTH = 64

# Rays per program and warps per program, chosen on an H100 (PERF.md):
# 128 rows x 8 warps ran the coarse phase and the first refine rung fastest
# or near it among blocks 64/128/256 x warps 2/4/8, and the 1080p frame in
# 0.56x the time of 4 warps — the chain of dependent small products is
# latency-bound, and more warps per block hide more of it.
BLOCK = 128
NUM_WARPS = 8

# Hidden-layer algorithm for Precision.HIGHEST on the GPU: IEEE f32 on the
# CUDA cores (see PERF.md's precision table for the choice).
HIGHEST_ALGORITHM = jax.lax.Precision.HIGHEST


def interpret_mode() -> bool:
    """True on the CPU backend (interpret mode), False on the GPU (Triton
    route). Any other backend has no route for these kernels."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"the march kernel runs on the GPU (Triton) or in interpret mode on "
        f"the CPU; backend {backend!r} has no route")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _width(params: MLPParams) -> int:
    return _next_pow2(max([16] + [int(l.w.shape[1]) for l in params[:-1]]))


def supports(params, scene: str) -> bool:
    """Whether the kernel can march this (net, scene): a kernel scene and a
    chain of at least two layers whose padded width is <= MAX_WIDTH.
    Everything else marches on the XLA path."""
    return (
        params is not None
        and scenes.kernel_supported(scene)
        and len(params) >= 2
        and int(params[-1].w.shape[1]) == 1
        and _width(params) <= MAX_WIDTH
    )


def pack_params(params: MLPParams):
    """Pack a chain into the kernel's two weight arrays.

    ``vec`` [R, H] holds, in order: the first layer's n_in weight rows, the
    biases of every layer but the head, the head's weight column, and the
    head bias as ``[b, 0, ..., 0]`` (added inside the head's row reduction).
    ``hid`` [max(L-2, 1), H, H] stacks the hidden layers' weights. Zero
    padding to the power-of-two width H is exact: padded units stay 0
    through every ReLU. Returns (vec, hid, n_in, H).
    """
    h = _width(params)
    n_in = int(params[0].w.shape[0])
    f32 = jnp.float32

    def row(v):
        v = jnp.asarray(v, f32).reshape(-1)
        return jnp.zeros((h,), f32).at[: v.shape[0]].set(v)

    rows = [row(params[0].w[k]) for k in range(n_in)]
    rows += [row(layer.b) for layer in params[:-1]]
    rows.append(row(params[-1].w[:, 0]))
    rows.append(row(params[-1].b))
    vec = jnp.stack(rows)
    vec = jnp.concatenate(
        [vec, jnp.zeros((_next_pow2(len(rows)) - len(rows), h), f32)])
    hidden = [
        jnp.zeros((h, h), f32).at[: l.w.shape[0], : l.w.shape[1]].set(
            l.w.astype(f32))
        for l in params[1:-1]
    ] or [jnp.zeros((h, h), f32)]
    return vec, jnp.stack(hidden), n_in, h


def _chain(px, py, pz, frame, vec_ref, hid_ref, *, n_in, n_hidden, precision):
    """The MLP chain on one block of points given as rows: [T] x3 -> [T]."""
    h = (px[:, None] * vec_ref[0][None, :]
         + py[:, None] * vec_ref[1][None, :]
         + pz[:, None] * vec_ref[2][None, :])
    if n_in == 4:
        h = h + frame * vec_ref[3][None, :]
    h = h + vec_ref[n_in][None, :]
    for l in range(n_hidden):
        h = jnp.maximum(h, 0.0)
        h = pl.dot(h, hid_ref[l], precision=precision) + vec_ref[n_in + 1 + l][None, :]
    h = jnp.maximum(h, 0.0)
    head = n_in + 1 + n_hidden
    return jnp.sum(h * vec_ref[head][None, :] + vec_ref[head + 1][None, :], axis=1)


def _march_kernel(
    dx_ref, dy_ref, dz_ref, t_ref, budget_ref, active_ref, scal_ref,
    vec_ref, hid_ref,
    t_out, conv_out, budget_out, active_out, steps_out,
    *, n_in, n_hidden, max_steps, march_eps, compose, precision,
    num_steps, relax_omega, track_resolve,
):
    # scal: [ox, oy, oz, frame, entry step count, 0, 0, 0]
    ox, oy, oz, frame = scal_ref[0], scal_ref[1], scal_ref[2], scal_ref[3]
    start = scal_ref[4].astype(jnp.int32)
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    relax = bool(relax_omega and relax_omega > 1.0)

    def sdf(t):
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        d = _chain(px, py, pz, frame, vec_ref, hid_ref,
                   n_in=n_in, n_hidden=n_hidden, precision=precision)
        return compose(px, py, pz, d, frame)

    def cond(carry):
        step, active = carry[0], carry[3]
        go = (step < max_steps) & (jnp.max(active) > 0.0)
        if num_steps is not None:
            # Bounded rung: at most num_steps from the entry step count,
            # like march.march_stage.
            go = go & (step - start < num_steps)
        return go

    def body(carry):
        # Same update order as singleMarch (volumeRender_kernel.cu:459-476)
        # and march.march_step / march_stage_relaxed: budget check before
        # the move, convergence after it.
        step, t, budget, active, conv, res = carry[:6]
        d = sdf(t)
        act = active > 0.0
        if relax:
            prev_r, step_len = carry[6:]
            sor_fail = act & (step_len > prev_r) & (d + prev_r < step_len)
            near = act & ~sor_fail & (d < march_eps)
            om = jnp.where(step_len < 0.0, 1.0, float(relax_omega))
            stepv = jnp.where(sor_fail, prev_r - step_len,
                              jnp.where(near, d, om * d))
        else:
            sor_fail = act & False
            near = act & (d < march_eps)
            stepv = d
        budget = budget - jnp.where(act, stepv, 0.0)
        miss = act & ~sor_fail & (budget <= 0.0)
        moved = act & ~miss
        t = jnp.where(moved, t + stepv, t)
        conv_now = moved & near
        still = moved & ~conv_now
        active = jnp.where(still, 1.0, 0.0)
        conv = jnp.where(conv_now, 1.0, conv)
        if track_resolve:
            res = jnp.where(act & ~still, (step + 1).astype(jnp.float32), res)
        out = (step + 1, t, budget, active, conv, res)
        if relax:
            prev_r = jnp.where(moved & ~sor_fail, d, prev_r)
            step_len = jnp.where(moved, stepv, step_len)
            out = out + (prev_r, step_len)
        return out

    t0 = t_ref[...]
    zeros = jnp.zeros_like(t0)
    init = (start, t0, budget_ref[...], active_ref[...], zeros,
            zeros + start.astype(jnp.float32))
    if relax:
        init = init + (zeros, zeros)
    step, t, budget, active, conv, res = jax.lax.while_loop(cond, body, init)[:6]
    t_out[...] = t
    conv_out[...] = conv
    budget_out[...] = budget
    active_out[...] = active
    exit_step = zeros + step.astype(jnp.float32)
    # Per-lane resolve step; unresolved lanes report the block's exit step.
    steps_out[...] = jnp.where(active > 0.0, exit_step, res) if track_resolve else exit_step


def _dot_precision(precision, interpret: bool):
    if interpret:
        # The CPU computes every f32 product exactly.
        return jax.lax.Precision.HIGHEST
    if precision == jax.lax.Precision.HIGHEST:
        return HIGHEST_ALGORITHM
    return precision


def march_state(
    params: MLPParams,
    origin: jax.Array,
    dirs: jax.Array,
    state: march.MarchState,
    config: RenderConfig,
    frame: jax.Array | float = 0.0,
    *,
    march_eps: float | None = None,
    precision=jax.lax.Precision.HIGHEST,
    num_steps: int | None = None,
    relax_omega: float = 0.0,
    return_resolve: bool = False,
    cyl_window: int | None = None,
    block: int = BLOCK,
):
    """Continue a march state inside the kernel (the staged scheduler's
    coarse phase and refine rungs).

    Semantics are march.march_stage's: plain stepping, or constant
    over-relaxed stepping with ``relax_omega`` > 1; ``num_steps`` bounds the
    rung (None = run to dry or max_steps). ``cyl_window`` overrides
    config.cyl_window for this call. ``return_resolve=True`` also returns
    the per-ray resolve step [n] float32 (the loop iteration at which each
    ray converged or missed) — the staged renderer's difficulty key for
    ordered packing.
    """
    if not supports(params, config.scene):
        raise ValueError(
            f"the march kernel does not support scene {config.scene!r} with "
            f"this network; the XLA march path handles it")
    interpret = interpret_mode()
    vec, hid, n_in, _ = pack_params(params)
    n = dirs.shape[0]
    block = min(block, _next_pow2(n))
    n_pad = pl.cdiv(n, block) * block

    def row(x):
        return jnp.zeros((n_pad,), jnp.float32).at[:n].set(x.astype(jnp.float32))

    scal = jnp.zeros((8,), jnp.float32)
    scal = scal.at[:3].set(jnp.reshape(origin, (3,)).astype(jnp.float32))
    scal = scal.at[3].set(jnp.asarray(frame, jnp.float32))
    scal = scal.at[4].set(state.steps.astype(jnp.float32))

    kernel = functools.partial(
        _march_kernel,
        n_in=n_in,
        n_hidden=len(params) - 2,
        max_steps=config.max_steps,
        march_eps=config.march_eps if march_eps is None else march_eps,
        compose=scenes.compose_fn(
            config.scene, config.cyl_window if cyl_window is None else cyl_window),
        precision=_dot_precision(precision, interpret),
        num_steps=num_steps,
        relax_omega=relax_omega,
        track_resolve=return_resolve,
    )
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    out_row = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    t_arr, conv, budget, active, steps_arr = pl.pallas_call(
        kernel,
        out_shape=(out_row,) * 5,
        grid=(n_pad // block,),
        in_specs=[lanes] * 6 + [whole(scal), whole(vec), whole(hid)],
        out_specs=(lanes,) * 5,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        # One name per role, so a trace tells the phases apart.
        name="march_kernel_{}_{}".format(
            "default" if precision == jax.lax.Precision.DEFAULT else "fine",
            "dry" if num_steps is None else num_steps),
    )(
        row(dirs[:, 0]), row(dirs[:, 1]), row(dirs[:, 2]),
        row(state.t), row(state.budget), row(state.active),  # pad lanes inactive
        scal, vec, hid,
    )

    if num_steps is None:
        # Run to dry: the scheduler's global counter advances by the deepest
        # block's iteration count (reported per lane).
        new_steps = jnp.max(steps_arr[:n]).astype(jnp.int32)
    else:
        # Bounded rungs ran exactly num_steps while actives remained, so
        # the counter stays a bound schedule_ok can rely on.
        new_steps = jnp.minimum(
            state.steps + jnp.asarray(num_steps, jnp.int32),
            jnp.asarray(config.max_steps, jnp.int32),
        )
    out_state = march.MarchState(
        t=t_arr[:n],
        budget=budget[:n],
        active=(active[:n] > 0.5) & state.active,
        converged=(conv[:n] > 0.5) | state.converged,
        steps=new_steps,
    )
    if return_resolve:
        return out_state, steps_arr[:n]
    return out_state


def _chain_kernel(px_ref, py_ref, pz_ref, scal_ref, vec_ref, hid_ref, out_ref,
                  *, n_in, n_hidden, precision):
    out_ref[...] = _chain(
        px_ref[...], py_ref[...], pz_ref[...], scal_ref[3], vec_ref, hid_ref,
        n_in=n_in, n_hidden=n_hidden, precision=precision)


def sdf_chain(params: MLPParams, pts: jax.Array, frame=0.0, *,
              precision=jax.lax.Precision.HIGHEST, block: int = BLOCK):
    """The kernel's MLP chain alone on points [n, 3] -> [n] — the march
    kernel's arithmetic, for measuring its SDF error at each precision."""
    if _width(params) > MAX_WIDTH:
        raise ValueError("network wider than the kernel's MAX_WIDTH")
    interpret = interpret_mode()
    vec, hid, n_in, _ = pack_params(params)
    n = pts.shape[0]
    block = min(block, _next_pow2(n))
    n_pad = pl.cdiv(n, block) * block
    cols = [jnp.zeros((n_pad,), jnp.float32).at[:n].set(pts[:, k]) for k in range(3)]
    scal = jnp.zeros((8,), jnp.float32).at[3].set(jnp.asarray(frame, jnp.float32))
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    out = pl.pallas_call(
        functools.partial(_chain_kernel, n_in=n_in, n_hidden=len(params) - 2,
                          precision=_dot_precision(precision, interpret)),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        grid=(n_pad // block,),
        in_specs=[lanes] * 3 + [whole(scal), whole(vec), whole(hid)],
        out_specs=lanes,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="sdf_chain",
    )(*cols, scal, vec, hid)
    return out[:n]

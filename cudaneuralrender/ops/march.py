"""Sphere tracing (ray marching) through an SDF — the render hot path.

Re-design of the reference's march machinery
(src/volumeRender_kernel.cu:293-477 kernels + :608-692 host loop). The
reference's architecture — per-step stream compaction (thrust scan,
:549-576), gather into a dense batch (:504-547), batched CUTLASS GEMMs, a
device->host batch-size sync every step (:562) — exists because divergent
per-pixel marching wastes a GPU. The base form here is a **dense, masked,
batched march under one jit**:

  * the whole image's sample points form one [N, 3] array fed to batched matmuls,
  * the march loop is a single ``lax.while_loop`` (zero host syncs; the
    reference pays one D2H sync per step),
  * lane masking replaces compaction within a stage.

For long tails (few active rays, many steps) there is a staged-compaction
variant (``march_stage`` + ops/compaction.py) that re-packs active rays into
a smaller dense batch every K steps — the reference's compaction amortized
over stages rather than paid every step — and the march kernel
(pallas/march_kernel.py) that keeps state on chip with per-block early exit.

March-step semantics are ordered exactly like singleMarch
(volumeRender_kernel.cu:459-476):
  1. dist = sdf(point)
  2. budget -= dist; if budget <= 0 -> miss (ray never moves this step)
  3. point += dir * dist
  4. if dist < eps -> converged
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .sdf import SdfFn


class MarchState(NamedTuple):
    """Per-ray march state (flat [N] arrays; points are recomputed as
    origin + dir * t each step instead of stored, trading a few flops for a
    3x smaller loop-carried state than the reference's d_points buffer)."""

    t: jax.Array          # [N] distance traveled along ray (from origin)
    budget: jax.Array     # [N] remaining march budget (reference d_tfar)
    active: jax.Array     # [N] bool: still marching
    converged: jax.Array  # [N] bool: hit surface
    steps: jax.Array      # [] int32: iterations executed


class MarchResult(NamedTuple):
    t: jax.Array          # [N] ray parameter of the final point
    hit: jax.Array        # [N] bool: converged on the surface
    steps: jax.Array      # [] int32 steps taken by the loop
    active: jax.Array     # [N] bool: unresolved at loop exit (budget left but
                          #     max_steps reached) -> background, like the
                          #     reference's unconverged-ray TODO (:690)


def intersect_sphere(
    origin: jax.Array, dirs: jax.Array, center, radius: float
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Analytic ray/sphere intersection (reference intersectSphere,
    volumeRender_kernel.cu:200-215). origin [3] or [N,3]; dirs [N,3].
    Returns (tnear [N], tfar [N], hit [N] bool). hit requires discriminant > 0
    (grazing rays excluded, same as the reference)."""
    center = jnp.asarray(center, dirs.dtype)
    q = origin - center  # broadcasts
    a = jnp.sum(dirs * dirs, axis=-1)
    b = 2.0 * jnp.sum(q * dirs, axis=-1)
    c = jnp.sum(q * q, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    hit = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    tnear = (-b - sq) / (2.0 * a)
    tfar = (-b + sq) / (2.0 * a)
    return tnear, tfar, hit


def init_state(
    origin: jax.Array,
    dirs: jax.Array,
    bound_center,
    bound_radius: float,
    t_init: jax.Array | None = None,
    warm_margin: float = 0.0,
) -> MarchState:
    """Per-ray init: bounding-sphere cull + starting point at the sphere's
    near intersection (reference initMarcher, volumeRender_kernel.cu:293-358).
    Rays that miss the bounding sphere start inactive (background).

    ``t_init`` (temporal warm start): per-ray suggested start depth from the
    previous frame of a smooth camera path; non-finite / <= 0 lanes mean "no
    suggestion" (cold). Warm lanes start at
    ``clip(t_init - warm_margin, tnear, tfar)`` with the budget reduced to
    preserve the reference invariant ``budget == tfar - (t - tnear)``
    (see _restore_state, render/renderer.py). The caller is responsible for
    the inside-surface reset guard (one SDF probe at the warm point)."""
    tnear, tfar, hit = intersect_sphere(origin, dirs, bound_center, bound_radius)
    tnear = jnp.maximum(tnear, 0.0)  # clamp to near plane (:342)
    # Reference stores tfar (distance from *origin* to far intersection) as
    # the budget and starts the ray at tnear — the budget is deliberately
    # generous by tnear (:344-354); kept for parity.
    t = jnp.where(hit, tnear, 0.0)
    budget = jnp.where(hit, tfar, 0.0)
    if t_init is not None:
        warm = hit & jnp.isfinite(t_init) & (t_init > 0.0)
        t_w = jnp.clip(t_init - warm_margin, tnear, tfar)
        t = jnp.where(warm, t_w, t)
        budget = jnp.where(warm, tfar - (t_w - tnear), budget)
    return MarchState(
        t=t,
        budget=budget,
        active=hit,
        converged=jnp.zeros_like(hit),
        steps=jnp.zeros((), jnp.int32),
    )


def march_step(sdf_fn: SdfFn, origin: jax.Array, dirs: jax.Array, s: MarchState, march_eps: float) -> MarchState:
    """One dense masked sphere-trace step over all rays (semantics of
    singleMarch, volumeRender_kernel.cu:459-476 — see module docstring)."""
    pts = origin + dirs * s.t[:, None]
    dist = sdf_fn(pts)

    budget = s.budget - jnp.where(s.active, dist, 0.0)
    miss = s.active & (budget <= 0.0)
    moved = s.active & ~miss

    t = jnp.where(moved, s.t + dist, s.t)
    conv_now = moved & (dist < march_eps)

    return MarchState(
        t=t,
        budget=budget,
        active=moved & ~conv_now,
        converged=s.converged | conv_now,
        steps=s.steps + 1,
    )


def sphere_trace(
    sdf_fn: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    *,
    max_steps: int = 6000,
    march_eps: float = 1e-6,
    bound_center=(0.0, 0.0, 0.0),
    bound_radius: float = 1.2,
) -> MarchResult:
    """Dense masked sphere trace with ``lax.while_loop`` — exits the moment
    every ray is resolved. Inference path (not reverse-differentiable; use
    sphere_trace_unrolled or diff/implicit.py for gradients)."""
    state = init_state(origin, dirs, bound_center, bound_radius)

    def cond(s: MarchState):
        return (s.steps < max_steps) & jnp.any(s.active)

    def body(s: MarchState):
        return march_step(sdf_fn, origin, dirs, s, march_eps)

    final = jax.lax.while_loop(cond, body, state)
    return MarchResult(t=final.t, hit=final.converged, steps=final.steps, active=final.active)


def sphere_trace_unrolled(
    sdf_fn: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    *,
    num_steps: int,
    march_eps: float = 1e-6,
    bound_center=(0.0, 0.0, 0.0),
    bound_radius: float = 1.2,
    remat: bool = True,
) -> MarchResult:
    """Fixed-length march via ``lax.scan`` — reverse-differentiable.

    Gradients flow through every step's SDF evaluation (the straightforward
    unrolled estimator; diff/implicit.py provides the O(1)-memory
    implicit-function alternative). ``remat`` checkpoints each step so the
    backward pass recomputes activations instead of storing all N*steps
    intermediates.
    """
    state = init_state(origin, dirs, bound_center, bound_radius)

    def body(s: MarchState, _):
        return march_step(sdf_fn, origin, dirs, s, march_eps), None

    if remat:
        body = jax.checkpoint(body)

    final, _ = jax.lax.scan(body, state, None, length=num_steps)
    return MarchResult(t=final.t, hit=final.converged, steps=final.steps, active=final.active)


def march_stage(
    sdf_fn: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    state: MarchState,
    *,
    num_steps,
    max_steps: int,
    march_eps: float,
    relax_omega: float = 0.0,
    newton: bool = False,
    omega_max: float = 8.0,
) -> MarchState:
    """Advance an existing state by up to ``num_steps`` (bounded while loop).

    Building block for the staged-compaction renderer: run a stage densely,
    then re-pack the survivors (ops/compaction.py) and continue on a smaller
    batch — the analogue of the reference's thrust-scan compaction
    (volumeRender_kernel.cu:549-576) without a per-step host sync.

    ``num_steps`` may be a traced scalar — the stage program is compiled once
    per batch capacity and reused for any stage length.

    ``relax_omega`` > 1 enables over-relaxed sphere tracing for this stage
    (see ``march_stage_relaxed``); 0/1 keeps the reference's plain stepping.
    """
    if relax_omega and relax_omega > 1.0:
        return march_stage_relaxed(
            sdf_fn, origin, dirs, state,
            num_steps=num_steps, max_steps=max_steps, march_eps=march_eps,
            omega=relax_omega, newton=newton, omega_max=omega_max,
        )
    start = state.steps
    num_steps = jnp.asarray(num_steps, jnp.int32)

    def cond(s: MarchState):
        return (s.steps < max_steps) & (s.steps - start < num_steps) & jnp.any(s.active)

    def body(s: MarchState):
        return march_step(sdf_fn, origin, dirs, s, march_eps)

    return jax.lax.while_loop(cond, body, state)


def march_stage_relaxed(
    sdf_fn: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    state: MarchState,
    *,
    num_steps,
    max_steps: int,
    march_eps: float,
    omega: float = 1.4,
    newton: bool = False,
    omega_max: float = 8.0,
) -> MarchState:
    """Over-relaxed sphere tracing stage ("enhanced sphere tracing",
    Keinert et al. 2014) as a masked per-ray FSM.

    ``newton=True`` makes the relaxation factor adaptive per ray from a
    secant slope estimate ("accelerated sphere tracing"): along the ray,
    d(t) locally ≈ g*(t*-t) with g = cos(incidence angle), so the Newton
    step d/g lands at the surface in one move where plain stepping needs
    log(d0/eps)/|log(1-g)| moves. g is estimated from the last two SDF
    samples ((d_prev - d)/step_len); the step multiplier is
    clip(1/g, 1, omega_max). Head-on rays (g≈1) step plainly — no
    overshoot oscillation — while grazing stragglers (g≈0.01-0.1) leap by
    omega_max. Receding rays (g<=0, past closest approach, headed for a
    budget miss) fall back to the constant ``omega``. Every overstep is
    still validated by the safety-sphere overlap check and backtracked on
    failure, so the Lipschitz no-miss guarantee is unchanged.

    Each active ray steps ``omega * d`` instead of ``d``. The overstep is
    safe while consecutive safety spheres overlap (``d_new + d_prev >=
    step_len`` — their union then covers the skipped segment, so no surface
    can be crossed); when they stop overlapping, the ray backtracks to the
    previous plain-step position (``t - step_len + d_prev``, always inside
    the previous safety sphere) and drops to omega=1 for the rest of the
    stage. Under the same 1-Lipschitz assumption plain sphere tracing makes,
    this never misses a surface — it just reaches it in ~1/omega as many MLP
    evaluations. Stage boundaries reset the relaxation state, re-arming
    omega after every compaction rung.

    Budget semantics: the budget decrements by the distance actually
    traveled (backtracks refund it), preserving the reference's
    total-march <= tfar invariant (volumeRender_kernel.cu:463-467);
    convergence still tests the raw SDF value against eps and advances by
    d on the converging step, exactly like ``march_step``.

    The extra per-ray state (prev_radius, step_len, omega) lives only in
    this stage's while_loop carry — MarchState is unchanged, so compaction
    gather/scatter between rungs needs no modification.
    """
    start = state.steps
    num_steps = jnp.asarray(num_steps, jnp.int32)
    n = dirs.shape[0]
    prev_r = jnp.zeros((n,), jnp.float32)
    step_len = jnp.zeros((n,), jnp.float32)

    def cond(carry):
        s = carry[0]
        return (s.steps < max_steps) & (s.steps - start < num_steps) & jnp.any(s.active)

    def body(carry):
        s, prev_r, step_len = carry
        pts = origin + dirs * s.t[:, None]
        d = sdf_fn(pts)

        # The overlap check only applies when the last step overstepped its
        # safety sphere (step_len > prev_r); plain steps that land inside the
        # surface (d < 0, possible with an approximate SDF) converge like the
        # reference instead of backtracking.
        overstepped = step_len > prev_r
        sor_fail = s.active & overstepped & (d + prev_r < step_len)
        near = s.active & ~sor_fail & (d < march_eps)

        if newton:
            # Secant slope of d along the ray from the last two samples.
            valid = step_len > 0.0
            g = (prev_r - d) / jnp.maximum(step_len, 1e-20)
            om = jnp.where(
                valid & (g > 0.0),
                jnp.clip(1.0 / jnp.maximum(g, 1.0 / omega_max), 1.0, float(omega_max)),
                jnp.where(valid, float(omega), 1.0),
            )
        else:
            # Constant over-relaxation; plain for exactly one step after a
            # failure (step_len < 0 marks the backtrack), then re-arm — a
            # permanent drop, as in the original formulation, forfeits the
            # whole remaining tail after a single overshoot. The fail->plain
            # pair guarantees forward progress, so this cannot livelock.
            om = jnp.where(step_len < 0.0, 1.0, float(omega))

        step = jnp.where(
            sor_fail, prev_r - step_len, jnp.where(near, d, om * d)
        )
        budget = s.budget - jnp.where(s.active, step, 0.0)
        miss = s.active & ~sor_fail & (budget <= 0.0)
        moved = s.active & ~miss
        # Budget check precedes convergence, like the reference
        # (volumeRender_kernel.cu:463-476): a ray that exhausts its budget
        # never moves and never converges, even if d < eps this step.
        conv_now = moved & near

        new_state = MarchState(
            t=jnp.where(moved, s.t + step, s.t),
            budget=budget,
            active=moved & ~conv_now,
            converged=s.converged | conv_now,
            steps=s.steps + 1,
        )
        prev_r = jnp.where(moved & ~sor_fail, d, prev_r)
        step_len = jnp.where(moved, step, step_len)
        return new_state, prev_r, step_len

    final, _, _ = jax.lax.while_loop(cond, body, (state, prev_r, step_len))
    return final

"""Cone-traced low-resolution depth prepass — a dense-ops empty-space skip.

Marches a (H/f × W/f) ray grid through the coarse SDF with **cone-safe**
steps, then hands every full-res ray a conservative starting depth via a
3×3 min-pool (``lax.reduce_window`` — dense ops only, no gathers; the
baked-grid alternative is ops/grid.py).

Soundness (the cone-tracing argument): a full-resolution ray from the same
pinhole origin stays within ``t * s`` of its nearest low-res ray at
parameter ``t``, where ``s`` is the low-res grid's diagonal ray spacing.
Stepping the low-res ray by ``(d − (s·t + m)) / (1 + s)`` keeps
``d(x) ≥ s·t + m`` along the *entire* walked segment, hence every point of
every covered full-res ray stays at least ``m`` outside the surface up to
the recorded stop depth. Rays whose whole cone reaches budget exhaustion
mark their full-res neighborhood dead — sky pixels never march at full
resolution at all. ``m`` must dominate the coarse SDF's error (DEFAULT
precision: 4.7e-2), so it defaults to the coarse epsilon.

The reference's only empty-space optimization is the analytic bounding
sphere (volumeRender_kernel.cu:325-340); this is its hierarchical
generalization, possible here because the whole march is one compiled
program rather than per-pixel CUDA threads.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .march import MarchState, init_state
from .sdf import SdfFn

_FAR = 1e30


def cone_trace(
    f: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    spacing: float,
    *,
    margin: float,
    bound_center,
    bound_radius: float,
    max_steps: int = 256,
) -> jax.Array:
    """March low-res rays with cone-safe steps; return per-ray safe depth.

    Returns t_stop [N]: the parameter below which the ray's whole cone is
    provably empty (margin-outside). _FAR for rays whose cone never meets
    the surface (budget death or bounding-sphere miss).
    """
    st = init_state(origin, dirs, bound_center, bound_radius)

    def cone_r(t):
        return spacing * t + margin

    def cond(carry):
        s, _ = carry
        return (s.steps < max_steps) & jnp.any(s.active)

    def body(carry):
        s, t_stop = carry
        pts = origin + dirs * s.t[:, None]
        d = f(pts)
        step = (d - cone_r(s.t)) / (1.0 + spacing)
        arrived = s.active & (step <= 0.0)
        walk = s.active & ~arrived
        step = jnp.where(walk, step, 0.0)
        budget = s.budget - step
        miss = walk & (budget <= 0.0)
        t = jnp.where(walk & ~miss, s.t + step, s.t)
        # arrived rays freeze their safe depth; missed rays stay _FAR
        t_stop = jnp.where(arrived, s.t, t_stop)
        return (
            MarchState(
                t=t,
                budget=budget,
                active=walk & ~miss,
                converged=s.converged,
                steps=s.steps + 1,
            ),
            t_stop,
        )

    t_stop0 = jnp.full(dirs.shape[:1], _FAR, jnp.float32)
    final, t_stop = jax.lax.while_loop(cond, body, (st, t_stop0))
    # Rays still active at step exhaustion: their current t is safe.
    return jnp.where(final.active, final.t, t_stop)


def prepass_init(
    f: SdfFn,
    origin: jax.Array,
    dirs: jax.Array,
    height: int,
    width: int,
    factor: int,
    *,
    margin: float,
    bound_center,
    bound_radius: float,
) -> MarchState:
    """Full-resolution MarchState initialized from a cone-traced prepass.

    The low-res grid is the strided subset of the full-res rays (identical
    NDC convention: generate_rays uses v = y/H·2−1, so row y=i·f of the
    full grid IS row i of the H/f grid). Every full-res ray starts at the
    min-pooled safe depth of its 3×3 low-res neighborhood (budget charged
    for the skipped distance, matching the reference's per-step budget
    decrement); rays whose entire neighborhood missed are dead on arrival.
    """
    hl, wl = height // factor, width // factor
    dirs_l = dirs.reshape(height, width, 3)[::factor, ::factor].reshape(-1, 3)
    # Diagonal NDC spacing of the low-res grid (ray dirs are unit vectors
    # from a shared origin; |d1 - d2| <= the pre-normalization NDC offset).
    spacing = 2.0 * float((1.0 / hl) ** 2 + (1.0 / wl) ** 2) ** 0.5
    t_stop = cone_trace(
        f, origin, dirs_l, spacing,
        margin=margin, bound_center=bound_center, bound_radius=bound_radius,
    )

    # 3x3 min-pool on the low-res depth map, then nearest upsample.
    t_map = t_stop.reshape(hl, wl)
    t_min = jax.lax.reduce_window(
        t_map, _FAR, jax.lax.min, (3, 3), (1, 1), "SAME"
    )
    t_up = jnp.repeat(jnp.repeat(t_min, factor, axis=0), factor, axis=1)
    t_up = t_up.reshape(-1)

    state = init_state(origin, dirs, bound_center, bound_radius)
    dead = t_up >= _FAR
    t_start = jnp.maximum(state.t, jnp.where(dead, state.t, t_up))
    return MarchState(
        t=t_start,
        budget=state.budget - (t_start - state.t),
        active=state.active & ~dead,
        converged=state.converged,
        steps=state.steps,
    )

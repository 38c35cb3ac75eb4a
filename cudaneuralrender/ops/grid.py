"""Baked distance-grid acceleration: empty-space skipping without matmuls.

The march's far-field cost is MLP evaluations on rays that are nowhere near
the surface (including sky rays that burn their whole budget). This module
bakes the scene SDF into a coarse 3-D grid once per frame (R³ evaluations —
~an eighth of ONE dense march step at R=64, 1080p) and marches rays through
the grid with conservative steps:

    step = trilinear(grid, x) - safety,   safety = cell diagonal

which cannot cross the surface as long as the SDF is 1-Lipschitz (the same
assumption sphere tracing itself makes; trilinear interpolation of a
1-Lipschitz field errs by at most half a cell diagonal, and the remaining
half covers the in-cell variation). Rays stop grid-marching when the grid
distance falls under `exit_dist` (handed to the MLP phases) or their budget
dies (miss — sky rays never touch the MLP at all).

An occupancy-grid analogue of NerfAcc/InstantNGP empty-space
skipping, adapted to SDFs: pure VPU gather+lerp per step, ~3-4x cheaper
than even a DEFAULT-precision MLP step, and fully fused into the scheduled
march program. The reference has no equivalent (its only cull is the
analytic bounding sphere, volumeRender_kernel.cu:325-340).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .march import MarchState
from .sdf import SdfFn


def bake(f: SdfFn, res: int, bound: float) -> jax.Array:
    """Sample the scene SDF at the centers of an res³ grid over [-bound, bound]³.

    Runs under jit inside the render program — re-baked per frame, so
    animated/CSG scenes need no cache invalidation.
    """
    axis = (jnp.arange(res, dtype=jnp.float32) + 0.5) / res * (2 * bound) - bound
    gx, gy, gz = jnp.meshgrid(axis, axis, axis, indexing="ij")
    pts = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return f(pts).reshape(res, res, res)


def trilinear(grid: jax.Array, x: jax.Array, bound: float) -> jax.Array:
    """Trilinear interpolation of grid at world points x (..., 3).

    Coordinates clamp to the cell-center lattice (valid because all march
    points live inside the bounding sphere, which the lattice covers).
    """
    res = grid.shape[0]
    c = (x + bound) / (2 * bound) * res - 0.5  # cell-center coords
    c = jnp.clip(c, 0.0, res - 1.000001)
    i0 = jnp.floor(c).astype(jnp.int32)
    frac = c - i0
    i1 = jnp.minimum(i0 + 1, res - 1)

    flat = grid.reshape(-1)

    def at(ix, iy, iz):
        return flat[(ix * res + iy) * res + iz]

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def grid_march(
    grid: jax.Array,
    origin: jax.Array,
    dirs: jax.Array,
    state: MarchState,
    *,
    bound: float,
    max_steps: int,
    grid_steps: int = 128,
    safety: float | None = None,
    exit_factor: float = 2.0,
) -> MarchState:
    """Advance rays through the baked grid until near-surface or miss.

    Rays whose interpolated distance is above ``exit_dist`` step by
    (distance − safety); the rest hold position and stay active for the MLP
    phases. Convergence is never declared here. Budget decrements by the
    actual distance moved, so a ray that exhausts its budget inside the grid
    is a miss that never cost a single matmul.
    """
    res = grid.shape[0]
    if safety is None:
        safety = (2 * bound / res) * (3.0 ** 0.5)
    exit_dist = exit_factor * safety
    start = state.steps

    def cond(s: MarchState):
        pts = origin + dirs * s.t[:, None]
        d = trilinear(grid, pts, bound)
        walking = s.active & (d - safety > exit_dist)
        return (
            (s.steps < max_steps)
            & (s.steps - start < grid_steps)
            & jnp.any(walking)
        )

    def body(s: MarchState):
        pts = origin + dirs * s.t[:, None]
        d = trilinear(grid, pts, bound)
        step = d - safety
        walk = s.active & (step > exit_dist)
        step = jnp.where(walk, step, 0.0)
        budget = s.budget - step
        miss = walk & (budget <= 0.0)
        t = jnp.where(walk & ~miss, s.t + step, s.t)
        return MarchState(
            t=t,
            budget=budget,
            active=s.active & ~miss,
            converged=s.converged,
            steps=s.steps + 1,
        )

    return jax.lax.while_loop(cond, body, state)

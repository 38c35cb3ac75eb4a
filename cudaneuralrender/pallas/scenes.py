"""In-kernel CSG scene composition for the march kernel.

The reference's checked-in sceneSDF composes the neural field with analytic
CSG inside its march kernel (manySphere at volumeRender_kernel.cu:217-230).
The march kernel (pallas/march_kernel.py) does the same: right after the MLP
chain of each step it applies one of these functions

    compose(px [T], py [T], pz [T], d [T], frame scalar) -> [T]

to the per-ray distance row. Each mirrors ops/sdf.py in the same op order
(the lax.scan over centers becomes an unrolled Python loop — identical
arithmetic). Kept apart from ops/sdf.py because the layouts differ ([..., 3]
points there, one row per coordinate here) and kernel code must avoid
constructs the Triton lowering rejects (scans with dynamic indexing, gathers
from captured arrays).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import sdf as sdf_ops

KERNEL_SCENES = frozenset(
    {
        "neural_raw",
        "neural_tanh",
        "many_sphere",
        "many_sphere_cut",
        "many_cylinder_cut",
        "displacement",
    }
)


def kernel_supported(scene: str) -> bool:
    """Scenes the march kernel can march (analytic-only 'sphere' excluded —
    it has no MLP chain and the dense XLA path is already trivial)."""
    return scene in KERNEL_SCENES


def _smooth_union(d1, d2, k):
    h = jnp.clip(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
    return d2 * (1.0 - h) + d1 * h - k * h * (1.0 - h)


def _smooth_subtract(d1, d2, k):
    h = jnp.clip(0.5 - 0.5 * (d1 + d2) / k, 0.0, 1.0)
    return d1 * (1.0 - h) - d2 * h + k * h * (1.0 - h)


def _many_sphere(px, py, pz, d, frame, do_union):
    # ops/sdf.many_sphere with the 9-center scan unrolled (reference
    # :176-196); centers' z is frame-animated.
    z_anim = -0.7 + frame * (2.0 * 0.7 / 360.0)
    centers = np.array(sdf_ops._MANY_SPHERE_CENTERS)  # [9, 3] static
    for cx, cy, _ in centers:
        dx = px - float(cx)
        dy = py - float(cy)
        dz = pz + z_anim  # center z = -z_anim
        sd = jnp.sqrt(dx * dx + dy * dy + dz * dz) - 0.1
        d = _smooth_union(d, sd, 0.01) if do_union else _smooth_subtract(d, sd, 0.01)
    return d


def _many_cylinder_cut(px, py, d, window: int = 5):
    """ops/sdf.many_cylinder_cut via a (window x window) grid window
    (reference :156-174).

    The 300 cylinders form a REGULAR 20x15 grid (spacing 0.1): column c has
    center x = -0.88 + 0.1c, row r center y = 0.42 - 0.1r. smooth_subtract
    with k=0.01 is an exact identity whenever d_scene + d_cyl >= 0.01, so a
    cylinder matters only within 0.03 + |d_scene| of the point. Evaluating
    the 5x5 cells around the nearest grid cell (pure per-lane arithmetic —
    centers are affine in the cell index, NO gathers) reproduces the full
    300-term chain exactly for every point with d_scene > -0.2; deeper
    interior points (never produced by the march, which stops at the
    surface) may differ. Order preserved: candidates iterate in (row, col)
    index order, matching the reference loop restricted to the non-identity
    subset.

    window=3 narrows the exact band: omitted cylinders then sit at grid
    Chebyshev distance >= 2, i.e. >= 2*0.1 - 0.05 (max off-center) - 0.02
    (radius/offset) ~ 0.11 from any evaluated point, so smooth_subtract
    (k=0.01) is an exact identity for every point with d_scene > -0.1 —
    the same interior-only error class as the 5x5's -0.2 band, asserted by
    tests/test_pallas.py::test_compose_fn_cylinder_window3_band.
    window=1 (nearest cylinder only) can only UNDERESTIMATE the scene
    distance, which is conservative for the coarse phase
    (RenderConfig.cyl_window_coarse).
    """
    assert window in (1, 3, 5), window
    half = window // 2
    offs = [float(k) for k in range(-half, half + 1)]
    c0 = jnp.floor((px + 0.88) / 0.1 + 0.5)  # nearest column, as float
    r0 = jnp.floor((0.42 - py) / 0.1 + 0.5)  # nearest row
    for dr in offs:
        for dc in offs:
            c = c0 + dc
            r = r0 + dr
            valid = (c >= 0.0) & (c <= 19.0) & (r >= 0.0) & (r <= 14.0)
            ox = 0.9 - 0.1 * c
            oy = -0.4 + 0.1 * r
            dx = px + ox - 0.02
            dy = py + oy - 0.02
            cyl = jnp.sqrt(dx * dx + dy * dy) - 0.02
            # invalid cells -> far away -> smooth_subtract identity
            cyl = jnp.where(valid, cyl, 1e9)
            d = _smooth_subtract(d, cyl, 0.01)
    return d


def _displacement(px, py, pz, d):
    s = jnp.sin(5.0 * px) * jnp.sin(5.0 * py) * jnp.sin(5.0 * pz)
    return jnp.tanh(d) + s * 0.05


def compose_fn(scene: str, cyl_window: int = 5):
    """Row-layout scene composition, or None for unsupported scenes.

    ``cyl_window`` selects many_cylinder_cut's grid window (see
    RenderConfig.cyl_window)."""
    if scene == "neural_raw":
        return lambda px, py, pz, d, frame: d
    if scene == "neural_tanh":
        return lambda px, py, pz, d, frame: jnp.tanh(d)
    if scene == "many_sphere":
        return lambda px, py, pz, d, frame: _many_sphere(px, py, pz, d, frame, True)
    if scene == "many_sphere_cut":
        return lambda px, py, pz, d, frame: _many_sphere(px, py, pz, d, frame, False)
    if scene == "many_cylinder_cut":
        return lambda px, py, pz, d, frame: _many_cylinder_cut(px, py, d, cyl_window)
    if scene == "displacement":
        return lambda px, py, pz, d, frame: _displacement(px, py, pz, d)
    return None

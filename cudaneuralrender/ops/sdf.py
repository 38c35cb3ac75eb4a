"""Analytic SDF primitives, CSG operators, and scene composition.

Re-design of the reference's __device__ SDF library
(src/volumeRender_kernel.cu:63-230). Every function here is a pure jnp
function over batched points ``p`` of shape (..., 3) returning (...,) —
fully vectorized so the whole image evaluates as a handful of fused VPU ops
instead of per-thread scalar code. Sequential CSG chains (the 300-cylinder
drill, the 9-sphere union) run under ``lax.scan``/``fori_loop`` over
precomputed static center arrays.

Scene composition: the reference hardcodes its scene inside sceneSDF
(src/volumeRender_kernel.cu:217-230, checked-in as ``manySphere(p,nSDF,true)``
with the plain-tanh path unreachable). Here scenes are a registry keyed by
name (``make_scene``), with the plain neural field as the default and CSG
demos as optional wrappers — quirk §3.6.2 of SURVEY.md fixed by design.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

# SdfFn: points (..., 3) -> distances (...,)
SdfFn = Callable[[jax.Array], jax.Array]


# ---------------------------------------------------------------------------
# Primitives (reference volumeRender_kernel.cu:67-101)
# ---------------------------------------------------------------------------

def sphere(p: jax.Array, radius: float, center=None) -> jax.Array:
    """Signed distance to a sphere (reference :67-71)."""
    if center is not None:
        p = p - jnp.asarray(center, p.dtype)
    return jnp.linalg.norm(p, axis=-1) - radius


def box(p: jax.Array, half_extent, round_radius: float = 0.0) -> jax.Array:
    """Signed distance to an axis-aligned (rounded) box (reference :81-89)."""
    q = jnp.abs(p) - jnp.asarray(half_extent, p.dtype)
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside - round_radius


def plane(p: jax.Array, height: float = 0.5) -> jax.Array:
    """Horizontal plane at y = height (reference :91-94 forces y - 0.5)."""
    return p[..., 1] - height


def cylinder(p: jax.Array, c) -> jax.Array:
    """Infinite cylinder, reference parameterization (:96-101).

    Parity note: the reference computes ``length((p.x, p.y) - (c.x, c.z)) - c.y``
    — an infinite cylinder along the *z* axis centered at (c.x, c.z) in the
    xy-plane with radius c.y. We reproduce that exact (quirky) convention so
    the manyCylinderCut demo scene matches.
    """
    c = jnp.asarray(c, p.dtype)
    d = jnp.stack([p[..., 0] - c[..., 0], p[..., 1] - c[..., 2]], axis=-1)
    return jnp.linalg.norm(d, axis=-1) - c[..., 1]


# ---------------------------------------------------------------------------
# Operators (reference :103-149)
# ---------------------------------------------------------------------------

def displace(p: jax.Array, d: jax.Array, freq: float = 5.0, amp: float = 0.05) -> jax.Array:
    """Sine-product displacement (reference :103-110)."""
    s = jnp.sin(freq * p[..., 0]) * jnp.sin(freq * p[..., 1]) * jnp.sin(freq * p[..., 2])
    return d + s * amp


def round_op(d: jax.Array, radius: float) -> jax.Array:
    """Round the surface outward (reference :112-115)."""
    return d - radius


def onion(d: jax.Array, thickness: float) -> jax.Array:
    """Hollow shell of given thickness (reference :117-121)."""
    return jnp.abs(d) - thickness


def intersect(d1: jax.Array, d2: jax.Array) -> jax.Array:
    return jnp.maximum(d1, d2)


def union(d1: jax.Array, d2: jax.Array) -> jax.Array:
    return jnp.minimum(d1, d2)


def subtract(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """d1 minus d2 (reference :133-136)."""
    return jnp.maximum(d1, -d2)


def smooth_subtract(d1: jax.Array, d2: jax.Array, k: float) -> jax.Array:
    """Polynomial smooth subtraction (reference :138-142)."""
    h = jnp.clip(0.5 - 0.5 * (d1 + d2) / k, 0.0, 1.0)
    mix = d1 * (1.0 - h) - d2 * h
    return mix + k * h * (1.0 - h)


def smooth_union(d1: jax.Array, d2: jax.Array, k: float) -> jax.Array:
    """Polynomial smooth union (reference :144-149)."""
    h = jnp.clip(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
    mix = d2 * (1.0 - h) + d1 * h
    return mix - k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Composite demo scenes (reference :151-196)
# ---------------------------------------------------------------------------

def _many_sphere_centers() -> np.ndarray:
    """The 9 sphere centers of manySphere (reference :176-196), before the
    frame-dependent z shift. Derived from the loop: cP starts at
    (p.x, p.y-0.6, p.z-0.7), every 3rd iteration bumps y by 0.4 and resets
    x to p.x+0.5, each iteration subtracts 0.4 from x *after* use.

    The distance to a sphere at offset o from p is |p - (-o)| i.e. the
    effective center is the negated accumulated offset.
    """
    centers = []
    y = -0.6
    x = 0.0
    for i in range(9):
        if i % 3 == 0:
            y += 0.4
            x = 0.5
        centers.append((x, y, -0.7))
        x -= 0.4
    # offsets are added to p, so world-space centers are the negation
    return -np.asarray(centers, dtype=np.float32)


_MANY_SPHERE_CENTERS = _many_sphere_centers()


def many_sphere(p: jax.Array, neural_d: jax.Array, frame: jax.Array, do_union: bool = True) -> jax.Array:
    """Nine animated spheres smooth-combined with the neural SDF (reference :176-196).

    frame animates the spheres' z position: z_shift = -0.7 + frame*2*0.7/360
    is added to the *offset* (i.e. subtracted from the world center).
    """
    z_anim = -0.7 + frame * (2.0 * 0.7 / 360.0)
    centers = jnp.asarray(_MANY_SPHERE_CENTERS)
    # _MANY_SPHERE_CENTERS already includes the -(-0.7) = +0.7 base; replace
    # the z component with the animated value (negated offset).
    centers = centers.at[:, 2].set(-z_anim)

    def body(d, c):
        sd = sphere(p - c, 0.1)
        if do_union:
            return smooth_union(d, sd, 0.01), None
        return smooth_subtract(d, sd, 0.01), None

    d, _ = jax.lax.scan(body, neural_d, centers)
    return d


def _many_cylinder_centers() -> np.ndarray:
    """The 300 cylinder params of manyCylinderCut (reference :156-174).

    cP starts at (p.x, p.y-0.5, p.z); every 20th iteration bumps y by 0.1 and
    resets x to p.x+0.9; each iteration smooth-subtracts a cylinder with
    c=(0.02,0.02,0.02) evaluated at cP, then shifts x by -0.1.

    cylinder(cP, c) depends on (cP.x - c.x, cP.y - c.z): with the reference's
    convention the grid lives in the x/y plane. We fold the accumulated
    (dx, dy) offsets into per-cylinder centers.
    """
    offs = []
    y = -0.5
    x = 0.0
    for i in range(300):
        if i % 20 == 0:
            y += 0.1
            x = 0.9
        offs.append((x, y))
        x -= 0.1
    return np.asarray(offs, dtype=np.float32)


_MANY_CYL_OFFSETS = _many_cylinder_centers()


def many_cylinder_cut(p: jax.Array, neural_d: jax.Array) -> jax.Array:
    """300-cylinder drill pattern smooth-subtracted from the neural SDF
    (reference :156-174). Sequential smooth ops are order-dependent, so this
    runs as a scan over the static offset table."""
    offsets = jnp.asarray(_MANY_CYL_OFFSETS)

    def body(d, off):
        # cylinder(cP, c) with cP = p + (off_x, off_y, 0), c = (0.02,)*3:
        # radial distance in the reference's (x, y) / (c.x, c.z) convention.
        dx = p[..., 0] + off[0] - 0.02
        dy = p[..., 1] + off[1] - 0.02
        cyl = jnp.sqrt(dx * dx + dy * dy) - 0.02
        return smooth_subtract(d, cyl, 0.01), None

    d, _ = jax.lax.scan(body, neural_d, offsets)
    return d


def many_cylinder_cut_windowed(
    p: jax.Array, neural_d: jax.Array, window: int = 3
) -> jax.Array:
    """Dense-layout twin of the kernel's grid window
    (pallas/scenes._many_cylinder_cut): only the (window x window) cells
    around each point's nearest grid cell are composed — identical
    arithmetic and (row, col) order to the kernel, exact wherever the
    scene distance exceeds the window's band (-0.1 for window=3, see the
    kernel docstring for the derivation). Used by the SHADING and gradient
    chains, whose evaluation points sit on the surface (d ~ 0), where the
    complete 300-term scan (many_cylinder_cut) would run inside the
    autodiff-normal chain. March-exactness consumers keep the full scan."""
    assert window in (1, 3, 5), window
    px, py = p[..., 0], p[..., 1]
    c0 = jnp.floor((px + 0.88) / 0.1 + 0.5)
    r0 = jnp.floor((0.42 - py) / 0.1 + 0.5)
    d = neural_d
    half = window // 2
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            c = c0 + dc
            r = r0 + dr
            valid = (c >= 0.0) & (c <= 19.0) & (r >= 0.0) & (r <= 14.0)
            ox = 0.9 - 0.1 * c
            oy = -0.4 + 0.1 * r
            dx = px + ox - 0.02
            dy = py + oy - 0.02
            cyl = jnp.sqrt(dx * dx + dy * dy) - 0.02
            cyl = jnp.where(valid, cyl, 1e9)
            d = smooth_subtract(d, cyl, 0.01)
    return d


def displacement_pattern(p: jax.Array, neural_d: jax.Array) -> jax.Array:
    """Sine displacement over tanh(neural) (reference :151-154)."""
    return displace(p, jnp.tanh(neural_d))


# ---------------------------------------------------------------------------
# Scene registry
# ---------------------------------------------------------------------------

def make_scene(
    name: str,
    neural_fn: Optional[SdfFn] = None,
    frame: jax.Array | float = 0.0,
    cyl_window: Optional[int] = None,
) -> SdfFn:
    """Compose a scene SDF from the raw neural field and CSG wrappers.

    Replaces the reference's hardcoded sceneSDF (volumeRender_kernel.cu:217-230):
      * "neural_raw"  — the checked-in consumption of the raw pre-tanh logit
      * "neural_tanh" — the intended plain path (tanh squashes the logit)
      * demo scenes   — manySphere / manyCylinderCut / displacement
      * "sphere"      — analytic-only, for tests without a network

    ``cyl_window``: surface-local callers (shading/gradient chains) pass
    RenderConfig.cyl_window to get the windowed many_cylinder_cut compose
    (many_cylinder_cut_windowed); None keeps the complete 300-term scan
    (march-exactness contract).
    """
    if name == "sphere":
        return lambda p: sphere(p, 0.9)

    if neural_fn is None:
        raise ValueError(f"scene {name!r} requires a neural SDF function")

    if name == "neural_raw":
        return neural_fn
    if name == "neural_tanh":
        return lambda p: jnp.tanh(neural_fn(p))
    if name == "many_sphere":
        return lambda p: many_sphere(p, neural_fn(p), frame, do_union=True)
    if name == "many_sphere_cut":
        return lambda p: many_sphere(p, neural_fn(p), frame, do_union=False)
    if name == "many_cylinder_cut":
        if cyl_window is not None:
            return lambda p: many_cylinder_cut_windowed(
                p, neural_fn(p), cyl_window
            )
        return lambda p: many_cylinder_cut(p, neural_fn(p))
    if name == "displacement":
        return lambda p: displacement_pattern(p, neural_fn(p))

    raise ValueError(f"unknown scene {name!r}")

"""Surface normals and shading (facing-ratio + matcap).

Replacement for the reference's shading device code
(src/volumeRender_kernel.cu:361-413). Two normal estimators:

  * ``autodiff_normals`` — exact gradient of the SDF via ``jax.grad``; the
    default (the SDF is a differentiable jnp function, so the
    "finite-difference trick" is unnecessary), and the same machinery the
    differentiable-rendering path uses.
  * ``tetrahedron_normals`` — the reference's 4-tap finite-difference
    (volumeRender_kernel.cu:362-377, constants :38-43, NORMAL_EPSILON :59),
    kept for bit-level parity studies.

Matcap shading follows matCapColor (volumeRender_kernel.cu:388-413): rotate
the world normal into eye space with the world->cam matrix, remap n.xy from
[-1,1] to texel coordinates, nearest-neighbor gather. The gather is a plain
XLA dynamic-gather over the [H*W, 3] texture — it runs once per pixel (not
per march step) so it stays outside the hot Pallas kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sdf import SdfFn

# Tetrahedron vertices for the 4-tap normal estimate
# (reference tetrahedronVerts, volumeRender_kernel.cu:38-43).
TETRAHEDRON_VERTS = np.array(
    [
        [1.0, -1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [-1.0, 1.0, -1.0],
        [1.0, 1.0, 1.0],
    ],
    dtype=np.float32,
)


def autodiff_normals(sdf_fn: SdfFn, points: jax.Array) -> jax.Array:
    """Exact unit normals: normalize(grad sdf). points (..., 3) -> (..., 3)."""

    def scalar_sdf(p):
        return jnp.reshape(sdf_fn(p[None, :]), ())

    g = jax.vmap(jax.grad(scalar_sdf))(points.reshape(-1, 3))
    g = g / jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g.reshape(points.shape)


def tetrahedron_normals(sdf_fn: SdfFn, points: jax.Array, eps: float = 1e-5) -> jax.Array:
    """4-tap finite-difference normals (reference surfaceNormal,
    volumeRender_kernel.cu:362-377): n = normalize(sum_i v_i * sdf(p + v_i*eps)).

    The four offset evaluations batch into ONE [4N, 3] SDF call — the same
    trick the reference's createBatch uses (mask value 4 expands a pixel to
    4 tetrahedron points, volumeRender_kernel.cu:529-546), but expressed as a
    reshape instead of a scatter.
    """
    verts = jnp.asarray(TETRAHEDRON_VERTS)  # [4, 3]
    flat = points.reshape(-1, 3)  # [N, 3]
    offs = flat[:, None, :] + verts[None, :, :] * eps  # [N, 4, 3]
    d = sdf_fn(offs.reshape(-1, 3)).reshape(-1, 4)  # [N, 4]
    n = jnp.einsum("nk,kc->nc", d, verts, precision=jax.lax.Precision.HIGHEST)
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n.reshape(points.shape)


def pack_rgba_u32(colors: jax.Array) -> jax.Array:
    """Device-side rgba pack: [..., 4] float in [0,1] -> [...] uint32.

    Byte layout and rounding mirror the reference's rgbaFloatToInt
    (volumeRender_kernel.cu:266-274): saturate to [0,1], scale by 255,
    TRUNCATE to integer, pack a<<24|b<<16|g<<8|r — the exact format the
    reference writes into its display PBO, and the same conversion
    utils.image_io.to_uint8_image applies on save. Used so the staged
    renderer's image-order restore sort carries ONE u32 payload instead of
    four f32 channels (the restore sort is the shading stage's dominant
    cost, benchmarks/exp_shade3.py).
    """
    c = (jnp.clip(colors, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    return (
        (c[..., 3] << 24) | (c[..., 2] << 16) | (c[..., 1] << 8) | c[..., 0]
    )


def unpack_rgba_u32(packed: jax.Array) -> jax.Array:
    """Inverse of pack_rgba_u32: [...] uint32 -> [..., 4] float rgba.

    Uses an explicit single f32 multiply by fl(1/255) — not a division,
    which XLA may or may not strength-reduce to the reciprocal, making the
    result backend-dependent by one ulp. The multiply is deterministic, and
    trunc(fl(k*fl(1/255))*255) == k for every k in 0..255 (verified
    exhaustively), so to_uint8_image recovers identical bytes to packing
    straight from the unquantized colors.
    """
    u8 = jnp.stack(
        [
            packed & 0xFF,
            (packed >> 8) & 0xFF,
            (packed >> 16) & 0xFF,
            (packed >> 24) & 0xFF,
        ],
        axis=-1,
    )
    return u8.astype(jnp.float32) * np.float32(1.0 / 255.0)


def facing_color(normals: jax.Array, dirs: jax.Array) -> jax.Array:
    """Facing-ratio grayscale (reference facingColor,
    volumeRender_kernel.cu:381-384): max(0, dot(n, -dir)) in rgb, alpha=1.
    normals/dirs (..., 3) -> rgba (..., 4)."""
    ratio = jnp.maximum(0.0, jnp.sum(normals * -dirs, axis=-1))
    return jnp.stack([ratio, ratio, ratio, jnp.ones_like(ratio)], axis=-1)


def matcap_color(
    normals: jax.Array, world_to_cam: jax.Array, matcap: jax.Array
) -> jax.Array:
    """Matcap lookup (reference matCapColor, volumeRender_kernel.cu:388-413).

    normals (..., 3) world-space unit normals; world_to_cam [4,4] (the
    reference's c_normalMatrix); matcap [Hm, Wm, C] float texture in [0,1]
    with row 0 = first decoded PNG row (the reference's loadPNG order,
    image.cu:53-59). Returns rgba (..., 4).
    """
    n_eye = jnp.matmul(normals, world_to_cam[:3, :3].T,  # w=0 transform (:391)
                       precision=jax.lax.Precision.HIGHEST)
    n_eye = n_eye / jnp.linalg.norm(n_eye, axis=-1, keepdims=True)

    hm, wm = matcap.shape[0], matcap.shape[1]
    # Nearest-neighbor texel (truncation, not rounding — parity with :398-399).
    ux = (n_eye[..., 0] * 0.5 + 0.5) * (wm - 1)
    uy = (n_eye[..., 1] * 0.5 + 0.5) * (hm - 1)
    ix = jnp.clip(ux.astype(jnp.int32), 0, wm - 1)
    iy = jnp.clip(uy.astype(jnp.int32), 0, hm - 1)

    texels = matcap[iy, ix]  # gather (..., C)
    if texels.shape[-1] == 3:
        alpha = jnp.ones(texels.shape[:-1] + (1,), texels.dtype)
        texels = jnp.concatenate([texels, alpha], axis=-1)
    return texels


def shade(
    sdf_fn: SdfFn,
    points: jax.Array,
    dirs: jax.Array,
    *,
    mode: str = "facing",
    normal_mode: str = "autodiff",
    normal_eps: float = 1e-5,
    world_to_cam: jax.Array | None = None,
    matcap: jax.Array | None = None,
) -> jax.Array:
    """Compute rgba colors for surface points. points/dirs (..., 3) -> (..., 4)."""
    if normal_mode == "autodiff":
        normals = autodiff_normals(sdf_fn, points)
    elif normal_mode == "tetrahedron":
        normals = tetrahedron_normals(sdf_fn, points, normal_eps)
    else:
        raise ValueError(f"unknown normal_mode {normal_mode!r}")

    if mode == "facing":
        return facing_color(normals, dirs)
    if mode == "matcap":
        if matcap is None or world_to_cam is None:
            raise ValueError("matcap shading requires a matcap texture and world_to_cam")
        return matcap_color(normals, world_to_cam, matcap)
    raise ValueError(f"unknown shading mode {mode!r}")

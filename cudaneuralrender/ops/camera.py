"""Camera model: view matrices and per-pixel eye-ray generation.

Replacement for the reference's Eigen camera math
(src/main.cpp:207-222) and the per-pixel ray setup of initMarcher
(src/volumeRender_kernel.cu:305-322). Instead of uploading matrices to CUDA
``__constant__`` memory each frame (copyViewMatrices,
volumeRender_kernel.cu:694-700), the camera is a small pytree of jnp arrays
passed as a traced argument — so interactive rotation/zoom re-runs the same
compiled program with new values (no recompilation, no host constant copies).

Conventions (parity with the reference):
  * camera-to-world matrix M = Rx(-rx) @ Ry(-ry) @ Translate(-T)
    (Eigen Affine rotate-then-translate right-multiplies: main.cpp:208-215).
  * eye origin = M @ [0,0,0,1]; with the default T=(0,0,-2) the eye orbits at
    distance 2 (zoom flag parses as viewTranslation.z = -zoom, main.cpp:608-612).
  * ray dir = normalize([u, v, -focal]) rotated by M's linear part —
    note normalization happens BEFORE rotation (volumeRender_kernel.cu:321-322);
    rotation preserves length so this equals post-normalization.
  * u = x/W*2-1, v = y/H*2-1 with pixel id = y*W + x; +v is world up, so ray
    row 0 is the image bottom. Image assembly flips at save time
    (the reference instead 180°-rotates in savePNG — SURVEY.md §3.6.9).
  * normal matrix = inverse(M) (world -> camera), used for matcap lookup
    (main.cpp:221, volumeRender_kernel.cu:391).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


_EXACT = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Camera:
    """Orbit camera: rotation in degrees, translation in world units."""

    rotation_x: jax.Array | float = 0.0
    rotation_y: jax.Array | float = 0.0
    translation: Tuple[float, float, float] | jax.Array = (0.0, 0.0, -2.0)

    def tree_flatten(self):
        return (
            (jnp.asarray(self.rotation_x, jnp.float32),
             jnp.asarray(self.rotation_y, jnp.float32),
             jnp.asarray(self.translation, jnp.float32)),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        rx, ry, t = children
        return cls(rx, ry, t)

    @classmethod
    def from_cli(cls, rx: float = 0.0, ry: float = 0.0, zoom: float = 2.0,
                 tx: float = 0.0, ty: float = 0.0) -> "Camera":
        """Mirror the reference CLI: -rx -ry -z (main.cpp:591-626).
        zoom z means viewTranslation.z = -z (default -2). tx/ty pan the
        view laterally — the reference's middle-drag (main.cpp:330-336)."""
        return cls(rotation_x=rx, rotation_y=ry, translation=(tx, ty, -zoom))


def _rot_x(deg: jax.Array) -> jax.Array:
    a = jnp.deg2rad(deg)
    c, s = jnp.cos(a), jnp.sin(a)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([one, zero, zero]),
            jnp.stack([zero, c, -s]),
            jnp.stack([zero, s, c]),
        ]
    )


def _rot_y(deg: jax.Array) -> jax.Array:
    a = jnp.deg2rad(deg)
    c, s = jnp.cos(a), jnp.sin(a)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([c, zero, s]),
            jnp.stack([zero, one, zero]),
            jnp.stack([-s, zero, c]),
        ]
    )


def view_matrices(camera: Camera) -> Tuple[jax.Array, jax.Array]:
    """Return (cam_to_world [3,4], world_to_cam [4,4]).

    cam_to_world is the reference's transposedModelView (top 3 rows of the
    model-view, main.cpp:217-219); world_to_cam is its normalMatrix = full
    inverse (main.cpp:221).
    """
    # Every product here is exact f32: the GPU would run a plain float32
    # matmul in TF32, whose ~1e-3 relative error moves every ray.
    r = jnp.matmul(_rot_x(-jnp.asarray(camera.rotation_x)),
                   _rot_y(-jnp.asarray(camera.rotation_y)), precision=_EXACT)
    t = jnp.asarray(camera.translation, jnp.float32)
    # M = R @ Translate(-t): linear part R, translation column R @ (-t).
    trans = jnp.matmul(r, -t, precision=_EXACT)
    cam_to_world = jnp.concatenate([r, trans[:, None]], axis=1)  # [3,4]

    # Inverse of [R | R@(-t); 0 0 0 1] is [R^T | t; 0 0 0 1].
    world_to_cam = jnp.eye(4, dtype=jnp.float32)
    world_to_cam = world_to_cam.at[:3, :3].set(r.T).at[:3, 3].set(t)
    return cam_to_world, world_to_cam


def ray_dirs_from_index(
    cam_to_world: jax.Array, idx: jax.Array, height: int, width: int,
    focal: float = 2.0
) -> jax.Array:
    """World-space ray directions for flat pixel indices idx [N] (= y*W + x).

    The direction is a pure function of the pixel index and the camera, so
    the staged renderer's packed-ray bundle carries only the index and
    recomputes directions at bucket granularity (~25 VPU flops/lane) instead
    of hauling three f32 payloads through every compaction sort —
    sort cost grows with payload count (benchmarks/exp_sortcost.py).
    """
    r = cam_to_world[:, :3]
    x = (idx % width).astype(jnp.float32)
    y = (idx // width).astype(jnp.float32)
    u = (x / width) * 2.0 - 1.0
    v = (y / height) * 2.0 - 1.0
    d_cam = jnp.stack([u, v, jnp.full_like(u, -focal)], axis=-1)  # [N, 3]
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    return jnp.matmul(d_cam, r.T, precision=_EXACT)  # rotate to world: (R @ d)


def generate_rays(
    cam_to_world: jax.Array, height: int, width: int, focal: float = 2.0
) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel eye rays. Returns (origin [3], dirs [H*W, 3]).

    Pixel (x, y) maps to NDC (u, v) = (x/W*2-1, y/H*2-1) and the flat index
    y*W + x (initMarcher, volumeRender_kernel.cu:313-322). The origin is shared
    by all rays (pinhole), so it is returned once and broadcast downstream —
    no [N,3] origin buffer (the reference stores per-pixel rays in HBM;
    here XLA keeps ray setup fused into the march). Delegates to
    ray_dirs_from_index so packed-bundle recomputation is bit-identical.
    """
    origin = cam_to_world[:, 3]
    idx = jnp.arange(height * width, dtype=jnp.int32)
    return origin, ray_dirs_from_index(cam_to_world, idx, height, width, focal)

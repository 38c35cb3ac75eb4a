"""Losses for inverse rendering and SDF distillation."""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..models import mlp
from ..models.mlp import MLPParams
from ..ops import camera as camera_lib
from ..ops import march
from ..ops.camera import Camera
from ..render.renderer import scene_fn
from ..utils.config import RenderConfig
from .implicit import render_image_diff


def pixel_loss(
    params: MLPParams,
    camera: Camera,
    config: RenderConfig,
    target: jax.Array,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
    *,
    t_star: Optional[jax.Array] = None,
    hit: Optional[jax.Array] = None,
    compact_cap: Optional[int] = None,
) -> jax.Array:
    """L2 pixel loss of a differentiable render vs a target [H, W, 4] image
    (BASELINE config 4: pixel-loss backprop to MLP weights).

    ``t_star``/``hit``: precomputed gradient-severed surface solve
    (diff/solve.py::solve_surface) — the fast path: the march leaves the
    loss/grad program entirely.

    ``compact_cap`` (requires t_star/hit): differentiate the shading of ONLY
    the hit rays, packed into a static [compact_cap] bucket — the grad-side
    twin of the inference path's compacted shading (renderer._shade_packed).
    Background pixels contribute a constant (zero-gradient) residual that is
    summed densely without autodiff, so the loss VALUE equals the dense
    formula exactly while the differentiated program shrinks from the whole
    image to the foreground bucket. The caller must pick compact_cap >= the hit count
    (compaction.capacity_bucket_of on the solve's hit stats —
    train.pixel_train_step_fast does this); overflow would silently drop
    hit pixels from the loss.
    """
    if compact_cap is not None:
        if t_star is None or hit is None:
            raise ValueError("compact_cap requires a precomputed t_star/hit")
        return _pixel_loss_compact(
            params, camera, config, target, matcap, frame, t_star, hit,
            compact_cap,
        )
    img = render_image_diff(
        params, camera, config, matcap, frame, t_star=t_star, hit=hit
    )
    return jnp.mean((img - target) ** 2)


def _pixel_loss_compact(
    params, camera, config, target, matcap, frame, t_star, hit, cap: int
) -> jax.Array:
    from ..ops import compaction, shading
    from ..render.renderer import _SHADE_PREC
    from .implicit import implicit_surface_t

    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    # Every evaluation in this loss happens at the solved surface (the
    # implicit reattachment at t*, the shading normals), so the compose may
    # be surface-local (windowed many_cylinder_cut).
    f = scene_fn(params, config, frame, surface_local=True)
    # The grad program is CHAIN-bound: the differentiated normals carry
    # second-order chain terms, so ONLY the shading chain runs at
    # grad_shade_precision. The implicit-t
    # reattachment keeps the full-precision chain (t* accuracy is the
    # surface solve's 1e-6 contract).
    f_shade = f
    shade_prec = _SHADE_PREC[config.grad_shade_precision]
    if shade_prec != jax.lax.Precision.HIGHEST:
        f_shade = scene_fn(
            params, config, frame, precision=shade_prec,
            surface_local=True,
        )
    hit = jax.lax.stop_gradient(hit)
    t_star = jax.lax.stop_gradient(t_star)
    tgt = target.reshape(-1, 4)

    # Pack hit lanes into a dense prefix with ONE variadic sort (the repo's
    # compaction idiom, ops/compaction.py sort_pack_leaves). All
    # sorted leaves are gradient-severed constants, so the sort never
    # appears in the backward pass. The ray DIRECTIONS do not ride the
    # sort: the carried pixel index reconstructs them in the bucket
    # (camera.ray_dirs_from_index — the inference bundle's slim-payload
    # idiom).
    pos = jnp.arange(tgt.shape[0], dtype=jnp.int32)
    packed = compaction.sort_pack_leaves(
        hit,
        (pos, t_star, tgt[:, 0], tgt[:, 1], tgt[:, 2], tgt[:, 3]),
    )
    origin = cam_to_world[:, 3]
    d_sub = camera_lib.ray_dirs_from_index(
        cam_to_world, packed[0][:cap], config.height, config.width,
        config.focal,
    )
    t_sub = packed[1][:cap]
    tgt_sub = jnp.stack([p[:cap] for p in packed[2:]], axis=-1)
    valid = jnp.arange(cap) < jnp.sum(hit.astype(jnp.int32))

    t = implicit_surface_t(f, origin, d_sub, t_sub)
    points = origin + d_sub * t[:, None]
    colors = shading.shade(
        f_shade, points, d_sub,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam,
        matcap=matcap,
    )
    res_fg = jnp.where(valid[:, None], colors - tgt_sub, 0.0)
    fg = jnp.sum(res_fg ** 2)
    # Background residual: rendered color is the constant 0 (no param
    # dependence), so sum without autodiff.
    bg = jnp.sum(jnp.where(hit[:, None], 0.0, tgt ** 2))
    return (fg + bg) / tgt.size


def pixel_loss_packed(
    params,
    camera,
    config,
    target,
    pos,
    t_packed,
    conv,
    cap: int,
    within: Optional[int] = None,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
) -> jax.Array:
    """_pixel_loss_compact consuming the solve's PACKED bundle directly
    (diff/solve.solve_surface_packed_async) — the two big sorts cancel:
    the solve skips its 2M-lane image-order restore, and the hit pack here
    sorts only the first ``within`` lanes (renderer._conv_within — the
    mixed path's invariant that every converged lane lives in the first
    refine bucket), with target rows gathered by the carried pixel index
    (a cap-sized gather instead of four 2M-lane sort payloads).

    The loss VALUE equals the dense formula up to summation order: the
    background residual is total target energy minus the hit rows' energy
    (misses render the constant 0), and hit ordering inside the bucket
    follows the bundle's packed order rather than image order — gradient
    semantics identical, float rounding differs at the ulp level.
    """
    from ..ops import compaction, shading
    from ..render.renderer import _SHADE_PREC
    from .implicit import implicit_surface_t

    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    f = scene_fn(params, config, frame, surface_local=True)
    f_shade = f
    shade_prec = _SHADE_PREC[config.grad_shade_precision]
    if shade_prec != jax.lax.Precision.HIGHEST:
        f_shade = scene_fn(
            params, config, frame, precision=shade_prec,
            surface_local=True,
        )
    pos = jax.lax.stop_gradient(pos)
    t_packed = jax.lax.stop_gradient(t_packed)
    conv = jax.lax.stop_gradient(conv)
    tgt = target.reshape(-1, 4)
    n = pos.shape[0]
    w = within if (within is not None and within < n) else n
    cap = min(cap, w)  # the bucket can never exceed the sorted prefix

    pos_h, t_h = compaction.sort_pack_leaves(
        conv[:w], (pos[:w], t_packed[:w])
    )
    pos_sub = pos_h[:cap]
    t_sub = t_h[:cap]
    origin = cam_to_world[:, 3]
    d_sub = camera_lib.ray_dirs_from_index(
        cam_to_world, pos_sub, config.height, config.width, config.focal
    )
    hit_count = jnp.sum(conv.astype(jnp.int32))
    valid = jnp.arange(cap) < hit_count

    t = implicit_surface_t(f, origin, d_sub, t_sub)
    points = origin + d_sub * t[:, None]
    colors = shading.shade(
        f_shade, points, d_sub,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam,
        matcap=matcap,
    )
    tgt_sub = jnp.take(tgt, pos_sub, axis=0)  # [cap, 4] gather (cap-sized)
    res_fg = jnp.where(valid[:, None], colors - tgt_sub, 0.0)
    fg = jnp.sum(res_fg ** 2)
    hit_energy = jnp.sum(jnp.where(valid[:, None], tgt_sub ** 2, 0.0))
    bg = jnp.sum(tgt ** 2) - hit_energy
    return (fg + bg) / tgt.size


def silhouette_loss(
    params: MLPParams,
    camera: Camera,
    config: RenderConfig,
    target_mask: jax.Array,
    sharpness: float = 50.0,
) -> jax.Array:
    """Soft-mask loss giving gradients to *non-hit* rays.

    The implicit pixel gradient only exists where rays converge; silhouette
    supervision needs a signal on misses too. Standard trick: the minimum SDF
    value along each ray (sampled at fixed depths) squashed through a sigmoid
    approximates hit probability; BCE against the target mask moves the
    surface toward/away from uncovered/covered pixels.
    """
    cam_to_world, _ = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    f = scene_fn(params, config, 0.0)

    tnear, tfar, hit = march.intersect_sphere(
        origin, dirs, config.bound_center, config.bound_radius
    )
    tnear = jnp.maximum(tnear, 0.0)
    n_samples = 64
    alphas = jnp.linspace(0.0, 1.0, n_samples)
    ts = tnear[:, None] + (tfar - tnear)[:, None] * alphas[None, :]  # [N, S]
    pts = origin + dirs[:, None, :] * ts[..., None]  # [N, S, 3]
    d = f(pts.reshape(-1, 3)).reshape(ts.shape)  # [N, S]
    min_d = jnp.min(jnp.where(hit[:, None], d, jnp.inf), axis=-1)
    min_d = jnp.where(hit, min_d, 1.0)

    p_hit = jax.nn.sigmoid(-sharpness * min_d)  # inside/near -> 1
    tgt = target_mask.reshape(-1).astype(jnp.float32)
    eps = 1e-6
    bce = -(tgt * jnp.log(p_hit + eps) + (1 - tgt) * jnp.log(1 - p_hit + eps))
    return jnp.mean(bce)


def sdf_distillation_loss(params: MLPParams, points: jax.Array, target_d: jax.Array) -> jax.Array:
    """MSE on raw SDF logits at sample points (teacher-student distillation /
    fitting an analytic SDF)."""
    pred = mlp.apply_scalar(params, points)
    return jnp.mean((pred - target_d) ** 2)


def eikonal_loss(params: MLPParams, points: jax.Array) -> jax.Array:
    """|grad f| = 1 regularizer — keeps the learned field a metric SDF so
    sphere tracing steps are valid."""

    def scalar(p):
        return jnp.reshape(mlp.apply_scalar(params, p[None, :]), ())

    g = jax.vmap(jax.grad(scalar))(points)
    norms = jnp.linalg.norm(g, axis=-1)
    return jnp.mean((norms - 1.0) ** 2)

"""Fast surface solve for the differentiable path.

Round-1's differentiable renderer marched the DENSE whole image
(ops/march.py::sphere_trace) to find each ray's surface parameter t* —
the march the inference path escapes via staged compaction. But the march is already gradient-severed (all
parameter sensitivity re-enters through diff/implicit.py's implicit-function
reattachment), so the t*-solve can use ANY solver, including the staged
scheduler and its march kernel, without touching gradient semantics.

This module provides that solver as a standalone phase:

    t_star, hit = solve_surface(params, camera, config)   # fast, no grads
    loss, grads = value_and_grad(pixel_loss)(params, ..., t_star=t_star, hit=hit)

``solve_surface`` is host-orchestrated exactly like render/renderer.py's
``render_staged`` (overflow retry with a widened refine schedule, dense
fallback for step-starved "full"-precision truncation) and therefore must be
called OUTSIDE any jit/grad trace. The differentiable phase
(implicit.render_image_diff / losses.pixel_loss with t_star passed in) is a
single clean jittable program: one SDF eval + one SDF gradient per hit pixel.

Equivalent reference structure: none — the reference is inference-only
(SURVEY.md §0); this makes its render loop (volumeRender_kernel.cu:652-689)
trainable at staged-path speed (BASELINE config 4 / round-1 VERDICT item 3).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera as camera_lib
from ..ops import march
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..utils.config import RenderConfig


def _make_check(stats, config: RenderConfig):
    """Deferred fast-path check closure shared by the async solve variants:
    fetches (or receives pre-fetched) the [4] stats vector, applies
    renderer.schedule_ok, and reports into stats_out."""
    from ..render.renderer import schedule_ok

    def check(stats_out: Optional[dict] = None, values=None) -> bool:
        if values is None:
            values = np.asarray(stats)
        active_count, steps_done, hit_count, refine_overflow = (
            int(v) for v in values[:4]
        )
        ok = schedule_ok(active_count, steps_done, refine_overflow, config)
        if stats_out is not None:
            stats_out.update(
                rays=config.num_rays, steps=steps_done, hits=hit_count,
                unresolved=active_count, refine_overflow=refine_overflow,
                fast_path=ok,
            )
        return ok

    check.stats = stats  # device array, for fused fetches
    return check


def _march_packed(params, camera: Camera, config: RenderConfig, frame):
    """Shared scheduled-march body: ray gen + renderer._scheduled_march +
    the stats vector ([:4] = health protocol, [4:] = per-rung entry actives
    for the adaptive tuner/retune — same layout as _render_scheduled's),
    bundle left PACKED (callers restore or consume)."""
    cam_to_world, _ = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    pr, steps, _within, refine_overflow, rungs = (
        renderer_lib._scheduled_march.__wrapped__(
            params, cam_to_world, origin, dirs, config, frame
        )
    )
    stats = jnp.concatenate(
        [
            jnp.stack(
                [
                    jnp.sum(pr.active.astype(jnp.int32)),
                    steps,
                    jnp.sum(pr.converged.astype(jnp.int32)),
                    refine_overflow,
                ]
            ),
            rungs,
        ]
    )
    return pr, stats


@functools.partial(jax.jit, static_argnames=("config",))
def _solve_scheduled(params, camera: Camera, config: RenderConfig, frame):
    """Staged-compaction t*-solve as ONE compiled program.

    Runs the inference path's full scheduled march (coarse kernel +
    precision ladder, renderer._scheduled_march), restores image order, and
    returns (t [N], hit [N], stats [4]) — no shading, no color restore sort.
    """
    # Counts come from the packed bundle; the restore sort then carries only
    # the two payloads the grad program consumes (t, converged) instead of
    # the full MarchState (the restore is payload-bandwidth-bound).
    pr, stats = _march_packed(params, camera, config, frame)
    from ..ops import compaction

    t, hit = compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged))
    return t, hit, stats


@functools.partial(jax.jit, static_argnames=("config",))
def _solve_dense(params, camera: Camera, config: RenderConfig, frame):
    """Dense whole-image solve (exact reference-ordered march) — the
    correctness fallback and the round-1 behavior."""
    cam_to_world, _ = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    f = renderer_lib.scene_fn(params, config, frame)
    result = march.sphere_trace(
        f,
        origin,
        dirs,
        max_steps=config.max_steps,
        march_eps=config.march_eps,
        bound_center=config.bound_center,
        bound_radius=config.bound_radius,
    )
    return result.t, result.hit


def solve_surface_async(
    params,
    camera: Camera,
    config: RenderConfig,
    frame: float = 0.0,
):
    """Dispatch the staged t*-solve WITHOUT the host stats check.

    Returns ``(t, hit, check)`` where t/hit are device arrays available
    immediately for dispatching downstream programs (e.g. the grad step) in
    the same device queue, and ``check()`` later fetches the stats and
    returns True iff the fast path sufficed. If check() is False the caller
    must discard the downstream results and redo the work via the
    synchronous ``solve_surface`` (rare: refine-bucket overflow or an
    exotic schedule). Saves one host round trip per step.
    """
    from ..render.renderer import memo_lookup

    frame = jnp.asarray(frame, jnp.float32)
    config = memo_lookup(params, config)
    t, hit, stats = _solve_scheduled(params, camera, config, frame)
    return t, hit, _make_check(stats, config)


def solve_surface(
    params,
    camera: Camera,
    config: RenderConfig,
    frame: float = 0.0,
    *,
    stats_out: Optional[dict] = None,
):
    """Solve every ray's surface parameter through the staged scheduler.

    Returns concrete ``(t_star [N], hit [N])`` device arrays in image order.
    Host-orchestrated (mirrors render_staged's control flow): refine-bucket
    overflow retries with a widened schedule; a step-starved "full"-precision
    truncation falls back to the dense exact march. Call OUTSIDE jit/grad.
    """
    from ..render.renderer import _widen_or_retune, memo_lookup, memo_teach

    frame = jnp.asarray(frame, jnp.float32)
    orig_config = config
    config = memo_lookup(params, config)
    t, hit, stats = _solve_scheduled(params, camera, config, frame)
    stats = np.asarray(stats)
    active_count, steps_done, hit_count, refine_overflow = (
        int(v) for v in stats[:4]
    )
    if stats_out is not None:
        stats_out.update(
            rays=config.num_rays,
            steps=steps_done,
            hits=hit_count,
            unresolved=active_count,
            refine_overflow=refine_overflow,
            fast_path=True,
        )

    if refine_overflow > 0:
        # Same retry rule as render_staged: resize the caps from this
        # frame's own rung stats, or double every refine bucket (and
        # mid-ladder bucket — overflow can originate from a HIGH rung). If
        # recovery no longer changes the config (all divs already 1, caps
        # at the image) the overflow cannot clear; finish on the exact
        # dense path instead of recursing forever. The shared adaptive
        # memo then lets future solves (and renders) of this config
        # dispatch the working schedule directly.
        widened = _widen_or_retune(config, stats)
        if widened == config:
            if stats_out is not None:
                stats_out.update(fast_path=False, dense_fallback=True)
            return _solve_dense(params, camera, config, frame)
        result = solve_surface(
            params, camera, widened, frame, stats_out=stats_out
        )
        memo_teach(params, orig_config, widened)
        if stats_out is not None:
            # After the recursion: its own update wrote fast_path=True on
            # success — this solve as a whole was not the fast path.
            stats_out.update(fast_path=False)
        return result

    if active_count > 0 and steps_done < config.max_steps:
        # Schedule left budgeted rays unresolved (tiny image / exotic
        # schedule) — finish on the exact dense path rather than porting the
        # staged continuation loop here.
        if stats_out is not None:
            stats_out.update(fast_path=False, dense_fallback=True)
        return _solve_dense(params, camera, config, frame)

    if (
        config.march_precision != "mixed"
        and active_count > 0
        and steps_done >= config.max_steps
    ):
        # "full" promises exact truncation semantics (every ray marches up
        # to max_steps) — same corner render_staged re-renders densely.
        if stats_out is not None:
            stats_out.update(fast_path=False, dense_fallback=True)
        return _solve_dense(params, camera, config, frame)

    return t, hit


@functools.partial(jax.jit, static_argnames=("config",))
def _solve_scheduled_packed(params, camera: Camera, config: RenderConfig, frame):
    """Staged t*-solve returning the PACKED bundle (no restore sort).

    The image-order restore (a 2M-lane sort) exists only for consumers that
    index rays by pixel; the compacted grad program re-packs by hit anyway,
    so handing it the packed (pos, t, converged) directly cancels BOTH
    sorts (diff/losses.pixel_loss_packed sorts only within the
    first refine bucket, where every hit lives — renderer._conv_within).
    Returns (pos, t, conv, stats).
    """
    pr, stats = _march_packed(params, camera, config, frame)
    return pr.pos, pr.t, pr.converged, stats


def solve_surface_packed_async(
    params,
    camera: Camera,
    config: RenderConfig,
    frame: float = 0.0,
):
    """Packed-bundle twin of ``solve_surface_async`` for the compacted grad
    program: returns (pos, t, conv, within, check) where ``within`` is the
    static prefix bound containing every converged lane (None when the
    bundle layout gives no bound — callers must then fall back to the
    image-order path). Same deferred-check contract."""
    from ..render.renderer import _conv_within, memo_lookup

    frame = jnp.asarray(frame, jnp.float32)
    config = memo_lookup(params, config)
    pos, t, conv, stats = _solve_scheduled_packed(params, camera, config, frame)
    within = _conv_within(config)
    return pos, t, conv, within, _make_check(stats, config)

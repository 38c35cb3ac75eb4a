"""Failure detection and recovery: tile-retry rendering + fault injection.

The reference has no failure handling of any kind — every CUDA error aborts
the process via checkCudaErrors (helper_cuda.h:591), and a failed load
exits (main.cpp:649-652). SURVEY.md §5 commits this framework to the
The story here: **rays are stateless, so recovery = recompute**. The image
is rendered in independent horizontal bands; a band whose execution fails
(device preemption, transient runtime error, injected fault) is simply
retried — no checkpointing, no coordination, and a lost band never corrupts
neighbors because sphere tracing has no cross-ray coupling.

Fault injection (`FaultInjector`) exercises the retry path deterministically
in tests and drills — the `--fault-inject` CLI debug flag plumbs into it.

Multi-host: parallel/multihost.py implements exactly this design across
processes — each host renders the row bands it owns (process_index
striding, ``render_bands``) and writes its own tiles; a failed host's bands
are adopted by the survivors (``band_owners``) and re-rendered from the
same camera. The band-retry loop below is that logic within one host.
"""
from __future__ import annotations

import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.mlp import MLPParams
from ..ops import camera as camera_lib
from ..ops import march, shading
from ..ops.camera import Camera
from ..render.renderer import scene_fn
from ..utils.config import RenderConfig

log = logging.getLogger("cudaneuralrender.fault")


class FaultInjector:
    """Deterministically fail the first `fail_times` band executions.

    The injected failure raises after the device work is issued — modeling a
    mid-render loss — so retry correctness (no partial-state contamination)
    is what gets exercised.
    """

    def __init__(self, fail_times: int = 0):
        self.fail_times = int(fail_times)
        self.injected = 0

    def maybe_fail(self, band: int) -> None:
        if self.injected < self.fail_times:
            self.injected += 1
            raise RuntimeError(f"injected fault on band {band} (#{self.injected})")


@functools.partial(jax.jit, static_argnames=("config", "n_bands"))
def _render_band(
    params, camera: Camera, config: RenderConfig, matcap, frame, band: jax.Array,
    n_bands: int,
):
    """Render one horizontal band of rows: [H/n_bands, W, 4].

    band is traced — all bands share ONE compiled program.
    """
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    rows = config.height // n_bands
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    start = band * rows * config.width
    dirs = jax.lax.dynamic_slice_in_dim(dirs, start, rows * config.width, axis=0)

    f = scene_fn(params, config, frame)
    result = march.sphere_trace(
        f, origin, dirs,
        max_steps=config.max_steps,
        march_eps=config.march_eps,
        bound_center=config.bound_center,
        bound_radius=config.bound_radius,
    )
    points = origin + dirs * result.t[:, None]
    f_shade = scene_fn(params, config, frame)
    colors = shading.shade(
        f_shade, points, dirs,
        mode=config.shading,
        normal_mode=config.normal_mode,
        normal_eps=config.normal_eps,
        world_to_cam=world_to_cam,
        matcap=matcap,
    )
    rgba = jnp.where(result.hit[:, None], colors, 0.0)
    return rgba.reshape(rows, config.width, 4)


@functools.partial(jax.jit, static_argnames=("config", "n_bands"))
def _render_band_staged(
    params, camera: Camera, config: RenderConfig, matcap, frame,
    band: jax.Array, n_bands: int,
):
    """One band through the STAGED fast path — the shared subset body
    (parallel.sharding.staged_subset) on the band's global indices in
    band-local block-major order. Returns ([rows, W, 4], stats [5]); the
    caller host-checks the stats and falls back to the exact dense band on
    the rare slow path. band is traced — all bands share ONE program.
    """
    from ..render import renderer as renderer_lib
    from .sharding import staged_subset

    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    rows = config.height // n_bands
    n_local = rows * config.width
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    perm = jnp.asarray(renderer_lib._block_order_np(
        rows, config.width,
        *(config.coarse_block or (rows, config.width))
    ))
    pos = band * jnp.int32(n_local) + perm
    rgba, stats5, _rungs = staged_subset(
        params, pos, cam_to_world, world_to_cam, config, matcap, frame,
    )
    return rgba.reshape(rows, config.width, 4), jnp.stack(stats5)


def _band_fast(stats, config: RenderConfig) -> bool:
    from .sharding import _sharded_fast

    return _sharded_fast(stats, config)


def render_band_auto(
    params, camera: Camera, config: RenderConfig, matcap, frame,
    band: int, n_bands: int,
) -> np.ndarray:
    """Render one band: staged fast path when the config asks for it, with
    a host stats check and exact dense fallback (rare); dense otherwise."""
    if config.march_impl == "staged":
        rgba, stats = _render_band_staged(
            params, camera, config, matcap, frame,
            jnp.asarray(band, jnp.int32), n_bands,
        )
        if _band_fast(stats, config):
            return np.asarray(rgba)
        # Overflow/slow path: the single-device widen machinery is per-frame;
        # bands are small and rare to overflow — finish exactly, densely.
    rgba = _render_band(
        params, camera, config, matcap, frame,
        jnp.asarray(band, jnp.int32), n_bands,
    )
    if config.rgba_packed and config.march_impl == "staged":
        rgba = shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))
    return np.asarray(rgba)


def render_tiled(
    params: Optional[MLPParams],
    camera: Camera,
    config: RenderConfig,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
    *,
    n_bands: int = 4,
    max_retries: int = 2,
    injector: Optional[FaultInjector] = None,
) -> np.ndarray:
    """Fault-tolerant render: per-band execute with retry-on-failure.

    Returns a host-side [H, W, 4] float32 image (bands are fetched as they
    complete — the elastic path is host-driven by design).
    """
    frame = jnp.asarray(frame, jnp.float32)
    rows = config.height // n_bands
    out = np.zeros((config.height, config.width, 4), np.float32)
    for band in range(n_bands):
        attempt = 0
        while True:
            try:
                band_img = render_band_auto(
                    params, camera, config, matcap, frame, band, n_bands,
                )  # np.asarray inside forces completion; device errors and
                # injected faults surface here
                if injector is not None:
                    injector.maybe_fail(band)
                out[band * rows:(band + 1) * rows] = band_img
                break
            except Exception as e:  # noqa: BLE001 — retry any band failure
                attempt += 1
                if attempt > max_retries:
                    raise RuntimeError(
                        f"band {band} failed {attempt} times; giving up"
                    ) from e
                log.warning("band %d failed (%s); retry %d/%d",
                            band, e, attempt, max_retries)
    return out

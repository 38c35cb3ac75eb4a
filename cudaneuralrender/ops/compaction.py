"""Active-ray compaction utilities (static-shape).

Analogue of the reference's per-step stream compaction
(thrust::exclusive_scan + createBatch gather,
src/volumeRender_kernel.cu:504-576). XLA requires static shapes, so instead
of a dynamic batch size read back to the host every step (the reference's
forced D2H sync at :562), compaction here is *staged*: the renderer runs K
dense steps, reads the surviving-ray count once, picks a static capacity
bucket, and gathers survivors into a dense prefix of that bucket. Capacity
buckets are powers of two so recompilation happens O(log N) times total.

Also fixes the reference's off-by-one (SURVEY.md §3.6.3: batch size read from
the last element of an *exclusive* scan undercounts when the final pixel is
active) — counts here are exact by construction.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def capacity_bucket(count: int, minimum: int = 256) -> int:
    """Smallest power-of-two >= count (>= minimum). Static Python int."""
    cap = max(int(minimum), 1)
    while cap < count:
        cap *= 2
    return cap


def capacity_bucket_of(count: int, total: int, minimum: int = 8192) -> int:
    """Coarse capacity bucket: total / 4^k, the largest shrink that still
    holds ``count`` (floored at ``minimum``). Buckets are a function of the
    *image size* only, so the staged renderer compiles at most
    log4(total/minimum) compacted-stage programs regardless of scene or
    camera (each XLA compile is expensive)."""
    cap = int(total)
    floor = max(int(minimum), 1)
    while cap // 4 >= max(int(count), floor):
        cap //= 4
    return min(cap, total)


def compact_indices(mask: jax.Array, capacity: int) -> Tuple[jax.Array, jax.Array]:
    """Indices of True lanes packed into a dense [capacity] prefix.

    Returns (indices [capacity] int32, valid [capacity] bool). Lanes beyond
    the true count point at slot 0 with valid=False (gathers are harmless,
    scatters masked). The packing is an exclusive cumsum scatter — the same
    scan the reference runs with thrust (volumeRender_kernel.cu:553-563), as
    one fused XLA op.
    """
    n = mask.shape[0]
    mask_i = mask.astype(jnp.int32)
    slots = jnp.cumsum(mask_i) - mask_i  # exclusive scan: slot per active lane
    count = jnp.sum(mask_i)

    src = jnp.arange(n, dtype=jnp.int32)
    # Scatter each active lane's index into its slot; inactive (or overflow,
    # when count > capacity) lanes write to a dump slot that is dropped.
    dest = jnp.where(mask & (slots < capacity), slots, capacity)
    indices = jnp.zeros((capacity + 1,), jnp.int32).at[dest].set(src)[:capacity]

    valid = jnp.arange(capacity) < count
    return indices, valid


def sort_pack_leaves(
    mask: jax.Array, leaves, within: int | None = None, order=None
):
    """Reorder every leaf so mask-True lanes form a dense prefix (stable,
    image order preserved within each group).

    ``order`` (optional, int-like [N]): secondary sort among mask-True lanes,
    ascending. Used for difficulty-ordered packing: packing a march bucket by
    predicted step count clusters stragglers into few kernel tiles, so
    easy tiles early-exit a bounded rung instead of idling until its fixed
    step count (per-block exit is the march kernel's compaction mechanism).
    Inactive lanes still sort strictly after every active lane.

    The compaction primitive of the staged renderer: ONE variadic
    ``lax.sort`` keyed on ``~mask`` carries every per-ray array in the same
    pass, instead of the cumsum+scatter index build (compact_indices) plus
    one gather/scatter per state leaf. The sort was chosen on the previous
    accelerator, where dynamic element addressing was slow; whether it still
    beats scan-and-scatter on the GPU is not yet measured (PERF.md).

    To restore the original order later, include an ``arange`` position
    payload here and sort by it afterwards (``sort_restore_leaves``).

    ``within``: only the first ``within`` lanes are reordered (the caller
    guarantees mask is False beyond them — true for nested rung packs where
    actives already live in the previous bucket's prefix); the suffix is
    passed through untouched, shrinking the sort to bucket size.
    """
    n = mask.shape[0]

    def make_key(m, o):
        """Composite UNIQUE key (base*span + lane index): an unstable sort
        on it is exactly the stable sort on the base key — identical
        permutation — without the tie-break pass a stable lowering adds. Base: 0/1 from the
        mask, or the clipped difficulty order (actives) vs a sentinel
        (inactives). Falls back to a plain stable sort when the composite
        would overflow int32 (order keys above ~8M lanes)."""
        span = m.shape[0]
        lane = jnp.arange(span, dtype=jnp.int32)
        if o is None:
            base = (~m).astype(jnp.int32)  # max composite 2*span - 1
            return base * jnp.int32(span) + lane, False
        if 256 * span >= 2 ** 31:
            return (
                jnp.where(m, jnp.maximum(o.astype(jnp.int32), 0),
                          jnp.int32(2 ** 30)),
                True,
            )
        base = jnp.where(
            m, jnp.clip(o.astype(jnp.int32), 0, 254), jnp.int32(255)
        )
        return base * jnp.int32(span) + lane, False

    if within is None or within >= n:
        key, stable = make_key(mask, order)
        out = jax.lax.sort(
            (key, *leaves), dimension=0, num_keys=1, is_stable=stable
        )
        return tuple(out[1:])
    key, stable = make_key(
        mask[:within], None if order is None else order[:within]
    )
    head = jax.lax.sort(
        (key, *(l[:within] for l in leaves)), dimension=0, num_keys=1,
        is_stable=stable,
    )
    return tuple(
        jnp.concatenate([h, l[within:]]) for h, l in zip(head[1:], leaves)
    )


def sort_restore_leaves(pos: jax.Array, leaves):
    """Undo any number of ``sort_pack_leaves`` reorderings in one sort: key on
    the carried original-position payload (a permutation), payloads follow."""
    out = jax.lax.sort((pos, *leaves), dimension=0, num_keys=1, is_stable=False)
    return tuple(out[1:])


def gather_state(tree, indices: jax.Array):
    """Gather leading-axis slices of every leaf in a pytree of [N, ...] arrays."""
    return jax.tree_util.tree_map(lambda a: a[indices], tree)


def scatter_state(full_tree, compact_tree, indices: jax.Array, valid: jax.Array):
    """Scatter compacted leaves back into the full-size pytree (valid lanes only)."""

    def put(full, comp):
        # Invalid lanes scatter to index n (out of bounds) — JAX drops
        # out-of-bounds scatter updates, so they cannot clobber live lanes.
        dump = jnp.asarray(full.shape[0], jnp.int32)
        safe = jnp.where(valid, indices, dump)
        return full.at[safe].set(comp, mode="drop")

    return jax.tree_util.tree_map(put, full_tree, compact_tree)


def capacity_pow2_of(count: int, total: int, minimum: int = 8192,
                     headroom: float = 1.25) -> int:
    """Snug power-of-2 capacity holding ``count`` with ``headroom`` slack.

    Finer-grained than ``capacity_bucket_of`` (powers of 2 vs powers of 4):
    used where the bucket is consumed by a single compiled program whose
    cost scales with capacity (the compacted grad shading,
    diff/losses.pixel_loss) — at ~172k hits in a 2M image the 4^k bucket
    lands on N/4 = 518k while 2^k with headroom gives 256k."""
    need = max(int(count * headroom), int(minimum), 1)
    cap = 1 << (need - 1).bit_length()
    return min(cap, int(total))

"""Compaction tests vs a numpy reference (replaces the reference's thrust
scan pipeline, volumeRender_kernel.cu:549-576 — including the exact-count fix
for SURVEY.md §3.6.3)."""
import numpy as np
import jax.numpy as jnp

from cudaneuralrender.ops import compaction


def test_capacity_bucket():
    assert compaction.capacity_bucket(0) == 256
    assert compaction.capacity_bucket(255) == 256
    assert compaction.capacity_bucket(257) == 512
    assert compaction.capacity_bucket(1, minimum=4) == 4


def test_compact_indices_basic():
    mask = jnp.array([False, True, False, True, True, False, False, True])
    idx, valid = compaction.compact_indices(mask, 8)
    np.testing.assert_array_equal(np.asarray(idx[:4]), [1, 3, 4, 7])
    np.testing.assert_array_equal(np.asarray(valid), [True] * 4 + [False] * 4)


def test_last_lane_active_counted():
    """The reference's exclusive-scan undercount bug: last pixel active must
    still be counted (SURVEY.md §3.6.3)."""
    mask = jnp.array([False] * 7 + [True])
    idx, valid = compaction.compact_indices(mask, 4)
    assert int(valid.sum()) == 1
    assert int(idx[0]) == 7


def test_compact_random_vs_numpy(rng):
    mask_np = rng.random(500) < 0.3
    mask = jnp.asarray(mask_np)
    cap = compaction.capacity_bucket(int(mask_np.sum()))
    idx, valid = compaction.compact_indices(mask, cap)
    want = np.nonzero(mask_np)[0]
    np.testing.assert_array_equal(np.asarray(idx)[: len(want)], want)
    assert int(valid.sum()) == len(want)


def test_gather_scatter_roundtrip(rng):
    n = 64
    mask_np = rng.random(n) < 0.4
    mask = jnp.asarray(mask_np)
    t = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    cap = compaction.capacity_bucket(int(mask_np.sum()), minimum=4)
    idx, valid = compaction.compact_indices(mask, cap)

    sub_t = t[idx] + 100.0  # "march" the compacted lanes
    (new_t,) = compaction.scatter_state((t,), (sub_t,), idx, valid)
    new_t = np.asarray(new_t)
    t_np = np.asarray(t)
    np.testing.assert_allclose(new_t[mask_np], t_np[mask_np] + 100.0, atol=1e-6)
    np.testing.assert_allclose(new_t[~mask_np], t_np[~mask_np], atol=1e-6)


def test_overflow_capacity_drops_excess():
    """count > capacity must not corrupt slots (overflow goes to dump slot)."""
    mask = jnp.ones((16,), bool)
    idx, valid = compaction.compact_indices(mask, 4)
    np.testing.assert_array_equal(np.asarray(idx), [0, 1, 2, 3])
    np.testing.assert_array_equal(np.asarray(valid), [True] * 4)


def test_sort_pack_leaves_basic(rng):
    n = 257
    mask_np = rng.random(n) < 0.3
    mask = jnp.asarray(mask_np)
    pos = jnp.arange(n, dtype=jnp.int32)
    vals = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    flags = jnp.asarray(rng.random(n) < 0.5)
    p_pos, p_vals, p_flags = compaction.sort_pack_leaves(mask, (pos, vals, flags))
    want = np.nonzero(mask_np)[0]
    k = len(want)
    # stable: active lanes first, original order preserved in both groups
    np.testing.assert_array_equal(np.asarray(p_pos[:k]), want)
    np.testing.assert_array_equal(np.asarray(p_pos[k:]), np.nonzero(~mask_np)[0])
    np.testing.assert_allclose(np.asarray(p_vals), np.asarray(vals)[np.asarray(p_pos)])
    np.testing.assert_array_equal(np.asarray(p_flags), np.asarray(flags)[np.asarray(p_pos)])


def test_sort_pack_within_prefix(rng):
    """within=k reorders only the first k lanes; suffix passes through."""
    n, k = 300, 128
    mask_np = np.zeros(n, bool)
    mask_np[: k] = rng.random(k) < 0.4
    mask = jnp.asarray(mask_np)
    pos = jnp.arange(n, dtype=jnp.int32)
    vals = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    p_pos, p_vals = compaction.sort_pack_leaves(mask, (pos, vals), within=k)
    want = np.nonzero(mask_np)[0]
    np.testing.assert_array_equal(np.asarray(p_pos[: len(want)]), want)
    np.testing.assert_array_equal(np.asarray(p_pos[k:]), np.arange(k, n))
    np.testing.assert_allclose(np.asarray(p_vals), np.asarray(vals)[np.asarray(p_pos)])


def test_sort_pack_restore_roundtrip(rng):
    """Any number of packs followed by one restore returns image order."""
    n = 400
    pos = jnp.arange(n, dtype=jnp.int32)
    vals = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    flags = jnp.asarray(rng.random(n) < 0.5)
    leaves = (pos, vals, flags)
    for p in (0.3, 0.6, 0.1):
        mask = jnp.asarray(rng.random(n) < p)
        leaves = compaction.sort_pack_leaves(mask, leaves)
    r_vals, r_flags = compaction.sort_restore_leaves(leaves[0], leaves[1:])
    np.testing.assert_allclose(np.asarray(r_vals), np.asarray(vals))
    np.testing.assert_array_equal(np.asarray(r_flags), np.asarray(flags))

"""Checkpoint loader tests (reference semantics: neuralNetwork.cpp:85-151)."""
import numpy as np
import pytest

import h5py
import jax.numpy as jnp

from cudaneuralrender.models import checkpoint, mlp


def test_load_plane1_shapes(plane1_params):
    sizes = mlp.layer_sizes(plane1_params)
    assert sizes == (3, 32, 32, 32, 32, 32, 32, 32, 32, 1)
    # Param counters (reference neuralNetwork.cpp:69-83): 9-layer MLP.
    assert mlp.num_weight_params(plane1_params) == 3 * 32 + 7 * 32 * 32 + 32 * 1
    assert mlp.num_bias_params(plane1_params) == 8 * 32 + 1
    assert mlp.num_params(plane1_params) == 7553


def test_load_matches_h5py_exactly(plane1_path, plane1_params):
    with h5py.File(plane1_path, "r") as f:
        w0 = np.asarray(f["dense/dense/kernel:0"])
        b0 = np.asarray(f["dense/dense/bias:0"])
        w8 = np.asarray(f["dense_8/dense_8/kernel:0"])
    np.testing.assert_array_equal(np.asarray(plane1_params[0].w), w0)
    np.testing.assert_array_equal(np.asarray(plane1_params[0].b), b0)
    np.testing.assert_array_equal(np.asarray(plane1_params[8].w), w8)


def test_layer_order_from_layer_names_attr(tmp_path):
    """Layer order must follow Keras layer_names, not HDF5 iteration order."""
    path = tmp_path / "weird_order.h5"
    with h5py.File(path, "w") as f:
        # create groups in scrambled creation order
        for name, n_in, n_out in [("dense_1", 4, 2), ("dense", 3, 4)]:
            g = f.create_group(name).create_group(name)
            g.create_dataset("kernel:0", data=np.full((n_in, n_out), 0.5, np.float32))
            g.create_dataset("bias:0", data=np.zeros(n_out, np.float32))
        f.attrs["layer_names"] = np.array([b"dense", b"dense_1"])
    params = checkpoint.load_keras_h5(str(path))
    assert mlp.layer_sizes(params) == (3, 4, 2)


def test_natural_sort_fallback(tmp_path):
    """Without layer_names: 'dense_10' must sort after 'dense_2'."""
    path = tmp_path / "ten_layers.h5"
    sizes = [3] + [8] * 10 + [1]
    with h5py.File(path, "w") as f:
        for i in range(11):
            name = "dense" if i == 0 else f"dense_{i}"
            g = f.create_group(name).create_group(name)
            g.create_dataset(
                "kernel:0", data=np.full((sizes[i], sizes[i + 1]), float(i), np.float32)
            )
            g.create_dataset("bias:0", data=np.zeros(sizes[i + 1], np.float32))
    params = checkpoint.load_keras_h5(str(path))
    assert mlp.layer_sizes(params) == tuple(sizes)
    # layer 10 (the last) must hold the value 10.0, proving order
    assert float(params[10].w[0, 0]) == 10.0


def test_bad_chain_rejected(tmp_path):
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        for i, (n_in, n_out) in enumerate([(3, 4), (5, 2)]):  # 4 != 5
            name = "dense" if i == 0 else f"dense_{i}"
            g = f.create_group(name).create_group(name)
            g.create_dataset("kernel:0", data=np.zeros((n_in, n_out), np.float32))
            g.create_dataset("bias:0", data=np.zeros(n_out, np.float32))
    with pytest.raises(ValueError, match="expects"):
        checkpoint.load_keras_h5(str(path))


def test_pytree_roundtrip(tmp_path, plane1_params):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_pytree(path, plane1_params)
    loaded = checkpoint.load_pytree(path)
    for a, b in zip(plane1_params, loaded):
        np.testing.assert_array_equal(np.asarray(a.w), np.asarray(b.w))
        np.testing.assert_array_equal(np.asarray(a.b), np.asarray(b.b))


def test_load_dispatch(tmp_path, plane1_path):
    params = checkpoint.load(plane1_path)
    assert len(params) == 9
    path = str(tmp_path / "c.npz")
    checkpoint.save_pytree(path, params)
    assert len(checkpoint.load(path)) == 9
    with pytest.raises(ValueError):
        checkpoint.load("model.bin")


def test_orbax_roundtrip(tmp_path, plane1_params):
    pytest.importorskip("orbax.checkpoint")
    from cudaneuralrender.models import checkpoint

    path = str(tmp_path / "orbax_ckpt")
    checkpoint.save_orbax(path, plane1_params)
    loaded = checkpoint.load_orbax(path)
    for a, b in zip(plane1_params, loaded):
        np.testing.assert_array_equal(np.asarray(a.w), np.asarray(b.w))
        np.testing.assert_array_equal(np.asarray(a.b), np.asarray(b.b))

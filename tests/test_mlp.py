"""MLP forward-pass tests vs a numpy reference implementation.

Mirrors the reference's simpleInfer correctness harness
(src/simpleInfer.cpp:81-146): known-input spot checks and the
batched-vs-single consistency property.
"""
import numpy as np
import jax
import jax.numpy as jnp

from cudaneuralrender.models import mlp


def numpy_mlp(params, x):
    """Independent reference: Keras dense chain, ReLU hidden, linear last."""
    h = np.asarray(x, np.float32)
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ np.asarray(layer.w) + np.asarray(layer.b)
        if i + 1 < n:
            h = np.maximum(h, 0.0)
    return h


def test_apply_matches_numpy_random(rng):
    params = mlp.init_mlp(jax.random.key(0))
    x = rng.standard_normal((257, 3)).astype(np.float32)
    got = np.asarray(mlp.apply(params, jnp.asarray(x)))
    want = numpy_mlp(params, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_apply_plane1(plane1_params, rng):
    x = rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32)
    got = np.asarray(mlp.apply(plane1_params, jnp.asarray(x)))
    want = numpy_mlp(plane1_params, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # output is a raw pre-tanh logit, single channel
    assert got.shape == (1024, 1)


def test_batch_identical_inputs_identical_outputs(plane1_params):
    """The reference's batchTest property (simpleInfer.cpp:135-146): a batch
    of identical inputs must produce bit-identical outputs."""
    x = jnp.zeros((100_000, 3), jnp.float32)
    y = np.asarray(jax.jit(mlp.apply)(plane1_params, x))
    assert np.all(y == y[0])


def test_single_equals_batched(plane1_params, rng):
    """Single-point forward equals the same row of a batched forward —
    the reference needs two GEMM paths for this (denseLayer.cu:251-278);
    here it is one code path, asserted anyway."""
    x = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    batched = np.asarray(mlp.apply(plane1_params, jnp.asarray(x)))
    single = np.stack(
        [np.asarray(mlp.apply(plane1_params, jnp.asarray(x[i : i + 1]))) for i in range(8)]
    ).reshape(8, 1)
    np.testing.assert_allclose(batched[:8], single, rtol=1e-6, atol=1e-7)


def test_apply_scalar_shape(plane1_params):
    x = jnp.zeros((10, 3))
    assert mlp.apply_scalar(plane1_params, x).shape == (10,)
    x2 = jnp.zeros((4, 5, 3))
    assert mlp.apply_scalar(plane1_params, x2).shape == (4, 5)


def test_origin_sdf_is_inside_plane1(plane1_params):
    """The SDF at the origin of a closed shape fit in [-1,1]^3 should be
    negative (inside) — sanity anchor on real weights."""
    d = float(mlp.apply_scalar(plane1_params, jnp.zeros((1, 3)))[0])
    assert -1.5 < d < 1.5  # logit scale sanity


def test_init_mlp_shapes():
    params = mlp.init_mlp(jax.random.key(1), sizes=(4, 16, 16, 2))
    assert mlp.layer_sizes(params) == (4, 16, 16, 2)
    mlp.validate_chain(params)


def test_grad_flows():
    params = mlp.init_mlp(jax.random.key(2))

    def loss(p):
        x = jnp.ones((8, 3))
        return jnp.sum(mlp.apply(p, x) ** 2)

    grads = jax.grad(loss)(params)
    total = sum(float(jnp.sum(jnp.abs(g.w))) for g in grads)
    assert total > 0.0

"""Dense MLP used as the neural SDF / occupancy field.

Replacement for the reference's layer stack:
  * abstract Layer / DenseLayer          (src/layers/layer.hh:7-27, denseLayer.hh:11-42)
  * CUTLASS GEMM + fused ReLU epilogues  (src/layers/denseLayer.cu:11-176)
  * NeuralNetwork::forward layer chain   (src/neuralNetwork.cpp:54-63)

Design: parameters are a plain pytree (tuple of ``DenseParams``); the forward
pass is a pure function whose matmuls XLA hands to cuBLAS or its own GEMM
kernels, with the bias-add + ReLU fused into the epilogue. There is no
mutable layer object, no output-buffer reuse (reference denseLayer.cu:229-248)
— functional purity removes the aliasing hazards documented in SURVEY.md §3.6.10.

Semantics parity notes:
  * Keras convention y = x @ W + b with W of shape (in, out) — the reference
    loads the same weights and transposes them for row-major GEMM
    (denseLayer.cu:217-227); we keep the natural (in, out) layout.
  * Hidden layers use ReLU, the final layer is *linear*: the reference tags
    the last layer "Tanh" (neuralNetwork.cpp:136-139) but never executes tanh
    in the GEMM epilogue (denseLayer.cu:93-113) — the raw logit is what the
    renderer consumes. ``apply`` reproduces that; scenes that want tanh apply
    it themselves (ops/sdf.py).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp


class DenseParams(NamedTuple):
    """One dense layer: y = x @ w + b.  w: (in, out), b: (out,)."""

    w: jax.Array
    b: jax.Array


# An MLP is a tuple of layers (a pytree).
MLPParams = Tuple[DenseParams, ...]


def init_mlp(
    key: jax.Array,
    sizes: Sequence[int] = (3, 32, 32, 32, 32, 32, 32, 32, 32, 1),
    dtype=jnp.float32,
) -> MLPParams:
    """Random init (He for ReLU hidden layers, Glorot for the head).

    Default architecture matches the shipped geometry files:
    9 dense layers 3->32, 32->32 x7, 32->1 (neuralGeometries/*.h5).
    """
    layers = []
    keys = jax.random.split(key, len(sizes) - 1)
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        if last:
            scale = jnp.sqrt(2.0 / (n_in + n_out))  # glorot
        else:
            scale = jnp.sqrt(2.0 / n_in)  # he
        w = jax.random.normal(keys[i], (n_in, n_out), dtype) * scale
        b = jnp.zeros((n_out,), dtype)
        layers.append(DenseParams(w, b))
    return tuple(layers)


def apply(
    params: MLPParams,
    x: jax.Array,
    *,
    dtype=None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Forward pass. x: (..., n_in) -> (..., n_out).

    ReLU on every layer but the last; last layer linear (raw logit — see
    module docstring).

    precision defaults to HIGHEST: the GPU computes f32 matmuls in TF32 by
    default, whose error breaks the renderer's eps=1e-6 convergence
    semantics. Max |error| against a float64 chain on an H100, csg_demo,
    1M points in [-1.2, 1.2]^3 (PERF.md): DEFAULT 2.9e-3, HIGH 3.0e-3
    (both TF32), HIGHEST 8.4e-7 (IEEE f32). Pass Precision.DEFAULT
    explicitly for the coarse phase, whose epsilon (0.05) dominates it.
    """
    h = x
    if dtype is not None:
        h = h.astype(dtype)
    n = len(params)
    for i, layer in enumerate(params):
        w, b = layer.w, layer.b
        if dtype is not None:
            w = w.astype(dtype)
            b = b.astype(dtype)
        h = jnp.dot(
            h, w, precision=precision, preferred_element_type=jnp.float32
        ) + b.astype(jnp.float32)
        if i + 1 < n:
            h = jnp.maximum(h, 0.0)
        if dtype is not None and i + 1 < n:
            h = h.astype(dtype)
    return h


def apply_scalar(params: MLPParams, x: jax.Array, **kw) -> jax.Array:
    """(..., n_in) -> (...) for single-output networks (SDF value)."""
    y = apply(params, x, **kw)
    return jnp.squeeze(y, axis=-1)


def num_weight_params(params: MLPParams) -> int:
    """Reference: NeuralNetwork::getNumWeightParams (neuralNetwork.cpp:69-75)."""
    return sum(int(l.w.size) for l in params)


def num_bias_params(params: MLPParams) -> int:
    """Reference: NeuralNetwork::getNumBiasParams (neuralNetwork.cpp:77-83)."""
    return sum(int(l.b.size) for l in params)


def num_params(params: MLPParams) -> int:
    return num_weight_params(params) + num_bias_params(params)


def layer_sizes(params: MLPParams) -> Tuple[int, ...]:
    """(n_in, hidden..., n_out) chain of the parameter pytree."""
    sizes = [int(params[0].w.shape[0])]
    for l in params:
        sizes.append(int(l.w.shape[1]))
    return tuple(sizes)


def validate_chain(params: MLPParams) -> None:
    """Check layer i's output width feeds layer i+1's input width."""
    for i in range(len(params) - 1):
        n_out = params[i].w.shape[1]
        n_in = params[i + 1].w.shape[0]
        if n_out != n_in:
            raise ValueError(
                f"layer {i} outputs {n_out} features but layer {i+1} expects {n_in}"
            )
    for i, l in enumerate(params):
        if l.b.shape != (l.w.shape[1],):
            raise ValueError(f"layer {i} bias shape {l.b.shape} != ({l.w.shape[1]},)")

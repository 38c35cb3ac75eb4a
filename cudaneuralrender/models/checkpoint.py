"""Checkpoint I/O: Keras-HDF5 ingestion and native pytree save/load.

Replacement for the reference's HighFive-based loader
(src/neuralNetwork.cpp:85-151): iterate top-level HDF5 groups, descend
group -> same-named group, classify datasets by rank (1-D = bias, 2-D =
kernel), and build the ordered dense chain. The reference relies on HDF5
iteration order matching layer order (SURVEY.md §3.5); we instead honor the
``layer_names`` attribute Keras writes, falling back to a natural-numeric
sort of the group names — strictly more robust, same result for the shipped
files.

The reference can only *load* (no training, no saving). Since this framework
is differentiable and trainable, we add a native checkpoint format
(save_pytree/load_pytree) using numpy's npz — dependency-free and
round-trip exact.
"""
from __future__ import annotations

import re
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from . import mlp
from .mlp import DenseParams, MLPParams


def _natural_key(name: str):
    """'dense' < 'dense_1' < 'dense_2' < ... < 'dense_10'."""
    parts = re.split(r"(\d+)", name)
    return [int(p) if p.isdigit() else p for p in parts]


def _ordered_layer_names(f) -> List[str]:
    names = f.attrs.get("layer_names")
    if names is not None:
        return [n.decode() if isinstance(n, bytes) else str(n) for n in names]
    return sorted(f.keys(), key=_natural_key)


def load_keras_h5(path: str, *, dtype=jnp.float32) -> MLPParams:
    """Load a Keras-exported dense-stack HDF5 file into an MLP pytree.

    Structure parity with neuralNetwork.cpp:91-134: each layer is a top-level
    group containing exactly one inner group (same name), whose datasets are
    the 1-D bias and 2-D kernel. Kernel is (in, out) Keras convention — used
    as-is (the reference transposes only because of its row-major GEMM,
    denseLayer.cu:217-227).
    """
    import h5py  # optional dependency: only the .h5 format needs it

    layers: List[DenseParams] = []
    with h5py.File(path, "r") as f:
        for name in _ordered_layer_names(f):
            obj = f[name]
            if not isinstance(obj, h5py.Group):
                raise ValueError(f"{path}: top-level object {name!r} is not a group")
            inner_names = list(obj.keys())
            if len(inner_names) != 1:
                raise ValueError(
                    f"{path}: layer group {name!r} has {len(inner_names)} children, expected 1"
                )
            inner = obj[inner_names[0]]
            w: Optional[np.ndarray] = None
            b: Optional[np.ndarray] = None
            for ds_name in inner.keys():
                ds = inner[ds_name]
                if not isinstance(ds, h5py.Dataset):
                    raise ValueError(f"{path}: {name}/{ds_name} is not a dataset")
                arr = np.asarray(ds)
                if arr.ndim == 1:
                    b = arr
                elif arr.ndim == 2:
                    w = arr
                else:
                    raise ValueError(
                        f"{path}: {name}/{ds_name} has rank {arr.ndim}; only dense layers supported"
                    )
            if w is None:
                raise ValueError(f"{path}: layer {name!r} has no 2-D kernel dataset")
            if b is None:
                b = np.zeros((w.shape[1],), dtype=w.dtype)
            layers.append(DenseParams(jnp.asarray(w, dtype), jnp.asarray(b, dtype)))

    params = tuple(layers)
    mlp.validate_chain(params)
    return params


def save_keras_h5(path: str, params: MLPParams) -> None:
    """Write an MLP pytree as a Keras-layout HDF5 weight file — the exact
    structure ``load_keras_h5`` (and the reference's NeuralNetwork::load,
    neuralNetwork.cpp:91-134) parses: one top-level group per layer named
    dense/dense_1/..., an inner group of the same name, datasets
    ``kernel:0`` (in, out) and ``bias:0``, plus the ``layer_names`` root
    attribute Keras writes. Geometries TRAINED by this framework
    (diff/train.fit_sdf, examples/train_sdf.py) therefore ship in the same
    format the whole pipeline — CLI, viewer, sharded render, and the CUDA
    reference itself — already consumes."""
    import h5py  # optional dependency: only the .h5 format needs it

    names = [f"dense_{i}" if i else "dense" for i in range(len(params))]
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        for name, layer in zip(names, params):
            inner = f.create_group(name).create_group(name)
            inner.create_dataset("kernel:0", data=np.asarray(layer.w))
            inner.create_dataset("bias:0", data=np.asarray(layer.b))


def save_pytree(path: str, params: MLPParams) -> None:
    """Save an MLP pytree as .npz (keys: w0,b0,w1,b1,...)."""
    arrays = {}
    for i, layer in enumerate(params):
        arrays[f"w{i}"] = np.asarray(layer.w)
        arrays[f"b{i}"] = np.asarray(layer.b)
    np.savez(path, **arrays)


def load_pytree(path: str, *, dtype=jnp.float32) -> MLPParams:
    """Load an MLP pytree saved by save_pytree."""
    with np.load(path) as data:
        n = len(data.files) // 2
        layers = [
            DenseParams(jnp.asarray(data[f"w{i}"], dtype), jnp.asarray(data[f"b{i}"], dtype))
            for i in range(n)
        ]
    params = tuple(layers)
    mlp.validate_chain(params)
    return params


def load(path: str, *, dtype=jnp.float32) -> MLPParams:
    """Load a model by extension: .h5/.hdf5 -> Keras, .npz -> native.

    Tags the loaded pytree with the file basename (utils/memo.py) so the
    staged renderer's adaptive-schedule memo can key on geometry identity
    and persist learned schedules across processes."""
    import os

    from ..utils import memo as _memo

    lower = path.lower()
    if lower.endswith((".h5", ".hdf5")):
        params = load_keras_h5(path, dtype=dtype)
    elif lower.endswith(".npz"):
        params = load_pytree(path, dtype=dtype)
    else:
        raise ValueError(f"unknown checkpoint format: {path}")
    # Absolute path, not basename: two different models named model.h5 in
    # different directories must not share one memo slot (a widened
    # schedule learned for one would silently slow the other, and the
    # overflow retry never corrects too-wide schedules).
    _memo.tag_geometry(params, os.path.abspath(path))
    return params


def save_orbax(path: str, params: MLPParams) -> None:
    """Save via orbax-checkpoint (async-capable, multi-host-aware — the
    production checkpointing layer for trained weights; npz remains the
    dependency-free default)."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(
            path,
            [{"w": np.asarray(l.w), "b": np.asarray(l.b)} for l in params],
        )


def load_orbax(path: str, *, dtype=jnp.float32) -> MLPParams:
    """Load a checkpoint written by save_orbax."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(path)
    params = tuple(
        DenseParams(jnp.asarray(l["w"], dtype), jnp.asarray(l["b"], dtype))
        for l in tree
    )
    mlp.validate_chain(params)
    return params

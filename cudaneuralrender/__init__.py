"""cudaneuralrender — a differentiable neural-implicit renderer in JAX.

A JAX/XLA/Pallas re-design of the capabilities of daviesthomas/cudaNeuralRender
(a CUDA sphere-tracing renderer for MLP-encoded SDFs): load Keras-HDF5 SDF
networks, sphere-trace them with a staged, compacted march whose phases run
in one GPU kernel each (pallas/march_kernel.py), shade with facing-ratio or
matcap, compose with analytic CSG — plus what the CUDA original lacks:
end-to-end differentiability (pixel loss -> weight gradients), multi-device
sharding via jax.sharding, multi-geometry batching, and training.

Quick start::

    import cudaneuralrender as cnr

    params = cnr.load("examples/assets/csg_demo.npz")
    cfg = cnr.RenderConfig(width=512, height=512)
    renderer = cnr.Renderer(params, cfg)
    img = renderer.render_frame(cnr.Camera.from_cli(ry=45.0))
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is set
# (JAX reads it itself), otherwise a fixed directory in the checkout, so
# repeat runs of the same programs skip compilation.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache = _os.path.join(_os.path.dirname(_os.path.dirname(__file__)), ".jax_cache")
    _os.makedirs(_cache, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", _cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .models import mlp
from .models.checkpoint import load, load_keras_h5, load_pytree, save_pytree
from .models.mlp import DenseParams, MLPParams, init_mlp
from .ops import bounds, camera, compaction, march, sdf, shading
from .ops.bounds import fit_bound_sphere
from .ops.camera import Camera
from .render.renderer import (
    Renderer,
    neural_sdf_fn,
    render_image,
    render_sequence,
    render_staged,
    reset_schedule_memo,
    scene_fn,
    tune_caps,
)
from .utils import image_io
from .utils.config import RenderConfig

__all__ = [
    "Camera",
    "DenseParams",
    "MLPParams",
    "RenderConfig",
    "Renderer",
    "bounds",
    "camera",
    "compaction",
    "fit_bound_sphere",
    "image_io",
    "init_mlp",
    "load",
    "load_keras_h5",
    "load_pytree",
    "march",
    "mlp",
    "neural_sdf_fn",
    "render_image",
    "render_sequence",
    "render_staged",
    "reset_schedule_memo",
    "tune_caps",
    "save_pytree",
    "scene_fn",
    "sdf",
    "shading",
]

"""Multi-chip dry run: compile + execute the full sharded pipeline.

Exercises, on an n-device mesh (virtual CPU devices or a real slice):
  * DP/SP — rays tile-sharded over the ``data`` axis for a full sphere-trace
    render (sequence-parallel analogue: rays are the sequence, SURVEY.md §5)
  * TP    — megatron-style tensor-parallel MLP weight sharding over ``model``
            in a full pixel->weight-gradient training step
  * EP    — multi-geometry (expert) parallelism: a stack of geometry MLPs
            sharded over ``model``, vmapped distillation step
  * grad all-reduce — data-parallel gradients psummed by GSPMD over the mesh

PP is intentionally absent: a 9-layer 32-wide MLP has no pipeline dimension
(SURVEY.md §2.4); the design doc notes layer pipelining as out of scope.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models import mlp
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import mesh as mesh_lib
from .sharding import render_image_sharded


def _mesh_shape(n: int):
    return (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)


def run(n_devices: int) -> None:
    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devices)} "
            "(set XLA_FLAGS=--xla_force_host_platform_device_count)"
        )
    dp, mp = _mesh_shape(n_devices)
    mesh = mesh_lib.make_mesh((dp, mp), ("data", "model"), devices)

    # ---- DP/SP: tile-sharded render on tiny shapes -------------------------
    # height = dp keeps the ray count divisible by the data axis for any n.
    cfg = RenderConfig(width=16, height=dp, scene="sphere", max_steps=32)
    img = render_image_sharded(None, Camera(), cfg, mesh)
    jax.block_until_ready(img)
    assert img.shape == (cfg.height, cfg.width, 4)

    # ---- TP + DP: full training step, tensor-parallel weights -------------
    hidden = 8 * mp  # divisible by the model axis
    params = mlp.init_mlp(jax.random.key(0), sizes=(3, hidden, hidden, hidden, 1))
    p_shard = mesh_lib.tp_mlp_shardings(params, mesh)
    params = jax.device_put(params, p_shard)

    batch = 16 * dp
    key = jax.random.key(1)
    pts = jax.device_put(
        jax.random.uniform(key, (batch, 3), minval=-1, maxval=1),
        NamedSharding(mesh, P("data", None)),
    )
    target = jax.device_put(
        jnp.linalg.norm(pts, axis=-1) - 0.5, NamedSharding(mesh, P("data"))
    )

    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, pts, target):
        def loss_fn(p):
            pred = mlp.apply_scalar(p, pts)
            return jnp.mean((pred - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, loss = train_step(params, opt_state, pts, target)
    jax.block_until_ready(loss)
    assert np.isfinite(float(loss))

    # ---- EP: expert (multi-geometry) parallel training step ---------------
    n_experts = mp * 2
    keys = jax.random.split(jax.random.key(2), n_experts)
    stacked = jax.vmap(lambda k: mlp.init_mlp(k, sizes=(3, 16, 16, 1)))(keys)
    e_shard = jax.tree_util.tree_map(
        lambda _: NamedSharding(mesh, P("model")), stacked
    )
    stacked = jax.device_put(stacked, e_shard)
    e_opt_state = opt.init(stacked)

    @jax.jit
    def expert_step(stacked, opt_state, pts, target):
        def loss_fn(sp):
            pred = jax.vmap(lambda p: mlp.apply_scalar(p, pts))(sp)  # [E, B]
            return jnp.mean((pred - target[None, :]) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(stacked)
        updates, opt_state = opt.update(grads, opt_state, stacked)
        return optax.apply_updates(stacked, updates), opt_state, loss

    stacked, e_opt_state, e_loss = expert_step(stacked, e_opt_state, pts, target)
    jax.block_until_ready(e_loss)
    assert np.isfinite(float(e_loss))

    # ---- config 5: tile-sharded differentiable render + grad all-reduce ---
    from ..diff import train as train_lib
    from .sharding import pixel_train_step_sharded

    dmesh = mesh_lib.make_mesh((n_devices,), ("data",), devices)
    r_params = mlp.init_mlp(jax.random.key(3))
    r_cfg = RenderConfig(width=16, height=n_devices, scene="neural_raw", max_steps=16)
    tgt = jnp.zeros((r_cfg.height, r_cfg.width, 4), jnp.float32)
    r_state = train_lib.init_train_state(r_params)
    r_state, r_loss = pixel_train_step_sharded(r_state, Camera(), tgt, r_cfg, dmesh)
    jax.block_until_ready(r_loss)
    assert np.isfinite(float(r_loss))

    # ---- config 5 FAST PATH: the staged scheduler under shard_map ---------
    # (the sharded product must be the staged/kernel path, not the dense
    # march.)
    from .sharding import render_image_sharded_staged, solve_surface_sharded

    import os as _os

    from ..models import checkpoint

    s_params = checkpoint.load(_os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))),
        "examples", "assets", "csg_demo.npz"))

    # 512-wide staged render per shard, XLA rung path (interpret-mode
    # kernels at this size would dominate the dryrun's budget on CPU;
    # the kernel shard body is exercised below at small shapes).
    s_cfg = RenderConfig(
        width=512, height=64 * n_devices, scene="neural_raw", max_steps=600,
        march_impl="staged", coarse_pallas=False, refine_pallas=False,
    )
    img = render_image_sharded_staged(s_params, Camera(rotation_y=25.0), s_cfg, dmesh)
    jax.block_until_ready(img)
    assert img.shape == (s_cfg.height, s_cfg.width, 4)

    # Kernel shard body (coarse + refine rungs in-kernel) at small shape.
    k_cfg = RenderConfig(
        width=32, height=4 * n_devices, scene="neural_raw", max_steps=64,
        march_impl="staged",
    )
    img_k = render_image_sharded_staged(s_params, Camera(rotation_y=25.0), k_cfg, dmesh)
    jax.block_until_ready(img_k)
    assert img_k.shape == (k_cfg.height, k_cfg.width, 4)

    # Sharded staged solve feeding the sharded train step (the training
    # fast path on a mesh: staged t* per shard, grads psummed by GSPMD).
    t_star, hit = solve_surface_sharded(s_params, Camera(rotation_y=25.0), k_cfg, dmesh)
    s_state = train_lib.init_train_state(s_params)
    s_tgt = jnp.zeros((k_cfg.height, k_cfg.width, 4), jnp.float32)
    s_state, s_loss = pixel_train_step_sharded(
        s_state, Camera(rotation_y=25.0), s_tgt, k_cfg, dmesh,
        t_star=t_star, hit=hit,
    )
    jax.block_until_ready(s_loss)
    assert np.isfinite(float(s_loss))

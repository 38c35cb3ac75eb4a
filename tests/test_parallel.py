"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: pjit sharding-equivalence — sharded render == single-device)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.parallel import dryrun, mesh as mesh_lib
from cudaneuralrender.parallel.sharding import render_image_sharded
from cudaneuralrender.models import mlp


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (XLA_FLAGS host_platform_device_count)")
    return jax.devices()[:8]


def test_make_mesh_shapes(eight_devices):
    m = mesh_lib.make_mesh()
    assert m.shape["data"] == len(jax.devices())
    m2 = mesh_lib.make_mesh((4, 2), ("data", "model"), eight_devices)
    assert m2.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh((3, 2), ("data", "model"), eight_devices)


def test_sharded_render_equals_single_device(eight_devices, plane1_params):
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200)
    m = mesh_lib.make_mesh((8, 1), ("data", "model"), eight_devices)
    sharded = np.asarray(render_image_sharded(plane1_params, cnr.Camera(), cfg, m))
    single = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), cfg))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_render_analytic(eight_devices):
    cfg = cnr.RenderConfig(width=16, height=16, scene="sphere", max_steps=64)
    m = mesh_lib.make_mesh((8, 1), ("data", "model"), eight_devices)
    sharded = np.asarray(render_image_sharded(None, cnr.Camera(), cfg, m))
    single = np.asarray(cnr.render_image(None, cnr.Camera(), cfg))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_indivisible_rays_rejected(eight_devices):
    cfg = cnr.RenderConfig(width=15, height=15, scene="sphere")
    m = mesh_lib.make_mesh((8, 1), ("data", "model"), eight_devices)
    with pytest.raises(ValueError, match="divisible"):
        render_image_sharded(None, cnr.Camera(), cfg, m)


def test_tp_shardings_cover_params(eight_devices):
    params = mlp.init_mlp(jax.random.key(0), sizes=(3, 16, 16, 16, 1))
    m = mesh_lib.make_mesh((4, 2), ("data", "model"), eight_devices)
    shardings = mesh_lib.tp_mlp_shardings(params, m)
    placed = jax.device_put(params, shardings)
    # TP-sharded forward must equal replicated forward
    x = jax.random.uniform(jax.random.key(1), (64, 3))
    a = np.asarray(mlp.apply_scalar(placed, x))
    b = np.asarray(mlp.apply_scalar(params, x))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip(eight_devices):
    """The driver's dryrun entry: full sharded train steps on 8 devices."""
    dryrun.run(8)


def test_dryrun_odd_device_count(eight_devices):
    dryrun.run(5)


def test_pixel_train_step_sharded_matches_unsharded(eight_devices, csg_params):
    """BASELINE config 5: tile-sharded differentiable render with grad
    all-reduce must produce exactly the single-device gradients/updates."""
    from cudaneuralrender.diff import train as train_lib
    from cudaneuralrender.parallel.sharding import pixel_train_step_sharded

    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    params = csg_params
    cfg = cnr.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=64)
    cam = cnr.Camera(rotation_y=20.0)
    target = jnp.asarray(
        np.asarray(cnr.render_image(params, cnr.Camera(rotation_y=24.0), cfg))
    )

    s0 = train_lib.init_train_state(params, lr=1e-3)
    sh_state, sh_loss = pixel_train_step_sharded(s0, cam, target, cfg, m)
    ref_state, ref_loss = train_lib.pixel_train_step(s0, cam, target, cfg)

    np.testing.assert_allclose(float(sh_loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(sh_state.params),
        jax.tree_util.tree_leaves(ref_state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_pixel_train_step_sharded_precomputed_solve(eight_devices, csg_params):
    """Sharded grad step fed by the staged surface solve (diff/solve.py):
    gradients must match the in-trace dense-march sharded step exactly at
    march_precision='full' (identical t*)."""
    from cudaneuralrender.diff import solve, train as train_lib
    from cudaneuralrender.parallel.sharding import pixel_train_step_sharded

    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    params = csg_params
    cfg = cnr.RenderConfig(width=16, height=16, scene="neural_raw",
                           max_steps=64, march_precision="full")
    cam = cnr.Camera(rotation_y=20.0)
    target = jnp.asarray(
        np.asarray(cnr.render_image(params, cnr.Camera(rotation_y=24.0), cfg))
    )

    t_star, hit = solve.solve_surface(params, cam, cfg)
    s0 = train_lib.init_train_state(params, lr=1e-3)
    fast_state, fast_loss = pixel_train_step_sharded(
        s0, cam, target, cfg, m, t_star=t_star, hit=hit
    )
    ref_state, ref_loss = pixel_train_step_sharded(s0, cam, target, cfg, m)

    np.testing.assert_allclose(float(fast_loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(fast_state.params),
        jax.tree_util.tree_leaves(ref_state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7)


def test_staged_sharded_matches_single_device(eight_devices, plane1_params):
    """The STAGED fast path under shard_map (round-3 VERDICT item 1): the
    8-shard staged render must equal the single-device staged render
    bit-for-bit — per-ray march math is lane-deterministic, so bucket
    boundaries (which differ per shard count) must not change any pixel.
    XLA rungs (kernels off) keep the 512² CPU run fast."""
    cfg = cnr.RenderConfig(
        width=512, height=512, scene="neural_raw", max_steps=6000,
        march_impl="staged", coarse_pallas=False, refine_pallas=False,
    )
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )

    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    stats = {}
    sharded = np.asarray(render_image_sharded_staged(
        plane1_params, cam, cfg, m, stats_out=stats))
    single = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    assert stats["fast_path"], stats
    np.testing.assert_array_equal(sharded, single)


def test_staged_sharded_with_kernels(eight_devices, csg_params):
    """Same parity with the march kernel phases ON (interpret mode on
    CPU) — certifies the actual production shard body, tiny resolution."""
    cfg = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=200,
        march_impl="staged",
    )
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )

    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    sharded = np.asarray(render_image_sharded_staged(
        csg_params, cam, cfg, m))
    single = np.asarray(cnr.render_staged(csg_params, cam, cfg))
    hit_a, hit_b = sharded[..., 3] > 0, single[..., 3] > 0
    # kernel tile boundaries differ between shard layouts; identical hit
    # sets and colors are still expected (per-lane determinism)
    np.testing.assert_array_equal(hit_a, hit_b)
    np.testing.assert_allclose(sharded, single, atol=1e-2)


def test_staged_sharded_matcap(eight_devices, plane1_params, matcap_path):
    """Matcap shading through the sharded staged path (gather + eye-space
    transform ride the shard body)."""
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )
    from cudaneuralrender.utils import image_io

    matcap = jnp.asarray(image_io.load_matcap(matcap_path))
    cfg = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=200,
        march_impl="staged", shading="matcap",
        coarse_pallas=False, refine_pallas=False,
    )
    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera(rotation_y=25.0)
    sharded = np.asarray(render_image_sharded_staged(
        plane1_params, cam, cfg, m, matcap=matcap))
    single = np.asarray(cnr.render_staged(
        plane1_params, cam, cfg, matcap=matcap))
    np.testing.assert_array_equal(sharded, single)


def test_staged_sharded_overflow_widens(eight_devices, plane1_params):
    """A refine overflow on any shard must retry the whole frame with the
    widened schedule through the same memo machinery as single-device."""
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=300,
        march_impl="staged", compact_min=8,
        refine_schedule=((1024, 4), (1024, 0)),
        coarse_pallas=False, refine_pallas=False,
    )
    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera()
    stats = {}
    img = np.asarray(render_image_sharded_staged(
        plane1_params, cam, cfg, m, stats_out=stats))
    assert not stats.get("fast_path", True)
    safe = np.asarray(render_image_sharded_staged(
        plane1_params, cam,
        cfg.replace(refine_schedule=((4, 16), (32, 0))), m))
    hit_a, hit_b = img[..., 3] > 0, safe[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.99
    cnr.reset_schedule_memo()


def test_solve_surface_sharded_matches(eight_devices, plane1_params):
    """Sharded staged t*-solve == single-device staged solve, and it feeds
    pixel_train_step_sharded to reproduce the dense-march gradients."""
    from cudaneuralrender.diff import solve, train as train_lib
    from cudaneuralrender.parallel.sharding import (
        pixel_train_step_sharded, solve_surface_sharded,
    )

    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=20.0)
    t_sh, hit_sh = solve_surface_sharded(plane1_params, cam, cfg, m)
    t_single, hit_single = solve.solve_surface(plane1_params, cam, cfg)
    hit_sh, hit_single = np.asarray(hit_sh), np.asarray(hit_single)
    np.testing.assert_array_equal(hit_sh, hit_single)
    # t compared on HIT rays only: a missed ray's final t depends on where
    # its budget ran out, and the recomputed bucket budget is a different
    # f32 summation order (PackedRays docstring) — the grad step never
    # reads t for misses (hit gates everything).
    np.testing.assert_allclose(
        np.asarray(t_sh)[hit_sh], np.asarray(t_single)[hit_single], atol=1e-6)

    target = jnp.asarray(np.asarray(cnr.render_image(
        plane1_params, cnr.Camera(rotation_y=24.0),
        cfg.replace(march_impl="while"))))
    s0 = train_lib.init_train_state(plane1_params, lr=1e-3)
    fast_state, fast_loss = pixel_train_step_sharded(
        s0, cam, target, cfg, m, t_star=t_sh, hit=hit_sh)
    assert np.isfinite(float(fast_loss))


def test_staged_sharded_animation_mode(eight_devices):
    """Animation mode (num_inputs=4: the frame number is the 4th MLP
    input, requiring a 4-input network) through the sharded staged path —
    the frame column and the per-shard subset body must agree with
    single-device."""
    from cudaneuralrender.parallel.sharding import (
        render_image_sharded_staged,
    )

    params = mlp.init_mlp(jax.random.key(5), sizes=(4, 32, 32, 1))
    cfg = cnr.RenderConfig(
        width=32, height=32, scene="neural_raw", max_steps=200,
        march_impl="staged", num_inputs=4,
        coarse_pallas=False, refine_pallas=False,
    )
    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera(rotation_y=25.0)
    for frame in (0.0, 120.0):
        sharded = np.asarray(render_image_sharded_staged(
            params, cam, cfg, m, frame=frame))
        single = np.asarray(cnr.render_staged(
            params, cam, cfg, frame=frame))
        np.testing.assert_array_equal(sharded, single)


def test_per_shard_stats_and_interleave_balance(eight_devices, plane1_params):
    """Per-shard observability (round-4 VERDICT item 2): the sharded staged
    program all_gathers a per-shard stats block, surfaced as load-balance
    metrics in stats_out; row-interleaved shard assignment keeps the
    near-set spread tight (imbalance <= 5% on plane_1 512²/8) while
    contiguous bands concentrate the object into few shards."""
    from cudaneuralrender.ops import camera as camera_lib
    from cudaneuralrender.parallel import sharding
    from cudaneuralrender.render import renderer as renderer_lib

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(
        width=512, height=512, scene="neural_raw", max_steps=1200,
        march_impl="staged", coarse_pallas=False, refine_pallas=False,
        adaptive_rungs=False,
    )
    m = mesh_lib.make_mesh((8,), ("data",), eight_devices)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    stats = {}
    sharding.render_image_sharded_staged(
        plane1_params, cam, cfg, m, stats_out=stats)
    # The observability block is present and self-consistent.
    assert len(stats["shard_near"]) == 8
    assert sum(stats["shard_hits"]) == stats["hits"]
    assert 0.0 < stats["predicted_scaling_efficiency"] <= 1.0
    # Row-interleaving: every shard sees a statistically identical scene
    # slice, so the near-set (refine entry) spread stays tight.
    near = np.asarray(stats["shard_near"], dtype=np.float64)
    interleaved_imb = near.max() / near.mean() - 1.0
    assert interleaved_imb <= 0.05, stats["shard_near"]
    assert stats["shard_imbalance"] <= 0.10, stats

    # Contiguous bands (the layout _shard_pos_np rejects): run the same
    # shard body on each band's indices and compare the near spread.
    n_local = cfg.num_rays // 8
    cam_to_world, world_to_cam = camera_lib.view_matrices(cam)
    import jax.numpy as jnp_

    near_bands = []
    for s in range(8):
        pos = jnp_.arange(s * n_local, (s + 1) * n_local, dtype=jnp_.int32)
        _, _, rungs = sharding.staged_subset(
            plane1_params, pos, cam_to_world, world_to_cam, cfg, None,
            jnp_.float32(0.0), solve_only=True,
        )
        near_bands.append(int(np.asarray(rungs)[0]))
    near_b = np.asarray(near_bands, dtype=np.float64)
    contiguous_imb = near_b.max() / near_b.mean() - 1.0
    assert contiguous_imb > 0.5, near_bands  # object concentrates in bands
    assert interleaved_imb < contiguous_imb / 10

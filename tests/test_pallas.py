"""March-kernel tests (pallas/march_kernel.py) in interpret mode on the CPU:
the kernel must reproduce march.march_stage / march.sphere_trace, and the
Triton route must lower for CUDA."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.models import mlp
from cudaneuralrender.ops import camera as cam_lib
from cudaneuralrender.ops import march
from cudaneuralrender.ops import sdf as sdf_ops
from cudaneuralrender.pallas import march_kernel as mk
from cudaneuralrender.pallas import scenes as kscenes
from cudaneuralrender.render.renderer import scene_fn


def _rays(cfg, cam=None):
    c2w, _ = cam_lib.view_matrices(cam or cnr.Camera(rotation_y=25.0, rotation_x=10.0))
    origin, dirs = cam_lib.generate_rays(c2w, cfg.height, cfg.width, cfg.focal)
    return origin, dirs


def _pair(params, cfg, *, frame=0.0, relax=0.0, num_steps=None, state=None,
          eps=None, cyl_window=None):
    """(kernel state, XLA march_stage state) from the same start state."""
    origin, dirs = _rays(cfg)
    if state is None:
        state = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    eps = cfg.march_eps if eps is None else eps
    got = mk.march_state(params, origin, dirs, state, cfg, frame,
                         march_eps=eps, relax_omega=relax, num_steps=num_steps,
                         cyl_window=cyl_window)
    f = scene_fn(params, cfg, frame)
    if cyl_window is not None:
        f = sdf_ops.make_scene(
            cfg.scene, cnr.neural_sdf_fn(params, frame, cfg.num_inputs), frame,
            cyl_window=cyl_window)
    ref = march.march_stage(
        f, origin, dirs, state,
        num_steps=cfg.max_steps if num_steps is None else num_steps,
        max_steps=cfg.max_steps, march_eps=eps, relax_omega=relax)
    return got, ref


def _assert_same_march(got, ref, *, agree=1.0, atol=1e-4, steps_tol=0):
    a, b = np.asarray(got.converged), np.asarray(ref.converged)
    assert (a == b).mean() >= agree, (a == b).mean()
    both = a & b
    assert both.sum() > 0
    np.testing.assert_allclose(np.asarray(got.t)[both], np.asarray(ref.t)[both], atol=atol)
    np.testing.assert_array_equal(np.asarray(got.active), np.asarray(ref.active))
    assert abs(int(got.steps) - int(ref.steps)) <= steps_tol


# anim_demo was trained on frame / 180 - 1; this is its frame 30.
ANIM_FRAME = 30.0 / 180.0 - 1.0

CFG = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)


def test_pack_params_layout(csg_params):
    vec, hid, n_in, h = mk.pack_params(csg_params)
    assert (n_in, h) == (3, 32)
    assert hid.shape == (7, 32, 32)
    assert vec.shape == (16, 32)  # 3 w0 rows + 8 biases + head + head bias -> 13 -> 16
    np.testing.assert_array_equal(np.asarray(vec[:3]), np.asarray(csg_params[0].w))
    np.testing.assert_array_equal(np.asarray(hid[0]), np.asarray(csg_params[1].w))
    np.testing.assert_array_equal(np.asarray(vec[11]), np.asarray(csg_params[8].w[:, 0]))
    assert float(vec[12, 0]) == float(csg_params[8].b[0])
    np.testing.assert_array_equal(np.asarray(vec[12, 1:]), 0.0)


@pytest.mark.parametrize("n", [300, 1024])
def test_sdf_chain_matches_xla(csg_params, n):
    """The kernel's chain (FMA input layer, tensor-core hidden layers, head
    reduction) equals the jnp chain, padded and unpadded batches."""
    pts = jax.random.uniform(jax.random.key(n), (n, 3), minval=-1.2, maxval=1.2)
    got = np.asarray(mk.sdf_chain(csg_params, pts))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, np.asarray(mlp.apply_scalar(csg_params, pts)),
                               atol=1e-5)


def test_sdf_chain_four_input(anim_params):
    pts = jax.random.uniform(jax.random.key(3), (500, 3), minval=-1.0, maxval=1.0)
    got = np.asarray(mk.sdf_chain(anim_params, pts, ANIM_FRAME))
    want = np.asarray(cnr.neural_sdf_fn(anim_params, ANIM_FRAME, 4)(pts))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kernel_plain_stepping(csg_params):
    _assert_same_march(*_pair(csg_params, CFG))


def test_kernel_relaxed_stepping(csg_params):
    """Same hit set, t and final actives; the loop length may differ by a
    few iterations, because a relaxed step's overlap test compares two SDF
    values whose last bits differ between the two chains."""
    _assert_same_march(*_pair(csg_params, CFG, relax=1.6), steps_tol=5)


def test_kernel_bounded_rung(csg_params):
    """num_steps bounds the rung from the entry step count, like
    march_stage; converged lanes stay converged."""
    origin, dirs = _rays(CFG)
    st = march.init_state(origin, dirs, CFG.bound_center, CFG.bound_radius)
    f = scene_fn(csg_params, CFG, 0.0)
    st = march.march_stage(f, origin, dirs, st, num_steps=8,
                           max_steps=CFG.max_steps, march_eps=CFG.march_eps)
    got, ref = _pair(csg_params, CFG, state=st, num_steps=16)
    assert int(got.steps) == 24
    assert np.asarray(got.active).sum() > 0  # the bound cut the march short
    _assert_same_march(got, ref)
    assert np.all(np.asarray(got.converged)[np.asarray(st.converged)])


def test_kernel_resolve_steps(csg_params):
    """Per-lane resolve step = the loop iteration at which each ray
    converged or missed (a one-step-at-a-time XLA march is the reference);
    unresolved lanes report the exit step."""
    cfg = CFG.replace(max_steps=40)
    origin, dirs = _rays(cfg)
    st = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    got, res = mk.march_state(csg_params, origin, dirs, st, cfg,
                              march_eps=0.05, return_resolve=True)
    f = scene_fn(csg_params, cfg, 0.0)

    def body(carry, i):
        s, r = carry
        s2 = march.march_step(f, origin, dirs, s, 0.05)
        r = jnp.where(s.active & ~s2.active, (i + 1).astype(jnp.float32), r)
        return (s2, r), None

    (ref, r_ref), _ = jax.lax.scan(body, (st, jnp.zeros(dirs.shape[0])),
                                   jnp.arange(cfg.max_steps))
    exit_step = float(got.steps)
    r_ref = jnp.where(ref.active, exit_step, jnp.where(st.active, r_ref, 0.0))
    np.testing.assert_array_equal(np.asarray(res), np.asarray(r_ref))


def test_kernel_four_input(anim_params):
    """The frame column enters the kernel's input layer as one more FMA,
    in another summation order than the jnp dot, so a ray may resolve one
    step apart."""
    cfg = CFG.replace(num_inputs=4)
    _assert_same_march(*_pair(anim_params, cfg, frame=ANIM_FRAME), steps_tol=2)


@pytest.mark.parametrize("scene", sorted(kscenes.KERNEL_SCENES))
def test_kernel_scene(csg_params, scene):
    """Every in-kernel composer marches like the XLA scene of the same
    window (many_cylinder_cut: the windowed dense composer)."""
    cfg = CFG.replace(scene=scene, max_steps=200)
    window = cfg.cyl_window if scene == "many_cylinder_cut" else None
    _assert_same_march(*_pair(csg_params, cfg, frame=17.0, eps=1e-3,
                              cyl_window=window))


def test_kernel_padding(csg_params):
    """n = 900 is not a multiple of the block: pad lanes are inactive and
    sliced off."""
    cfg = CFG.replace(width=30, height=30)
    got, ref = _pair(csg_params, cfg)
    assert got.t.shape == (900,)
    _assert_same_march(got, ref)


def test_kernel_block_size_invariant(csg_params):
    """Per-ray results do not depend on the block size (per-lane march)."""
    origin, dirs = _rays(CFG)
    st = march.init_state(origin, dirs, CFG.bound_center, CFG.bound_radius)
    a = mk.march_state(csg_params, origin, dirs, st, CFG, block=64)
    b = mk.march_state(csg_params, origin, dirs, st, CFG, block=256)
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(a.converged), np.asarray(b.converged))


def test_kernel_wide_net_in_kernel():
    """A 64-wide net (the widest the kernel takes) marches in-kernel."""
    params = mlp.init_mlp(jax.random.key(2), sizes=(3, 64, 64, 64, 1))
    assert mk.supports(params, "neural_raw")
    cfg = CFG.replace(width=16, height=16, max_steps=64)
    _assert_same_march(*_pair(params, cfg))


@pytest.mark.parametrize("width", [128, 256])
def test_wide_net_routes_to_xla(width):
    """Nets wider than MAX_WIDTH go to the XLA march: the kernel refuses
    them and the staged render (kernels on) equals the dense render."""
    params = mlp.init_mlp(jax.random.key(2), sizes=(3, width, width, 1))
    assert not mk.supports(params, "neural_raw")
    cfg = cnr.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=64,
                           march_impl="staged", march_precision="full",
                           rgba_packed=False)
    with pytest.raises(ValueError, match="does not support"):
        origin, dirs = _rays(cfg)
        st = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
        mk.march_state(params, origin, dirs, st, cfg)
    img_s = np.asarray(cnr.render_staged(params, cnr.Camera(), cfg))
    img_d = np.asarray(cnr.render_image(params, cnr.Camera(), cfg))
    np.testing.assert_allclose(img_s, img_d, atol=1e-5)


def test_kernel_rejects_analytic_only_scene(csg_params):
    assert not mk.supports(csg_params, "sphere")
    assert not mk.supports(None, "neural_raw")
    with pytest.raises(ValueError, match="does not support"):
        _pair(csg_params, CFG.replace(scene="sphere"))


@pytest.mark.parametrize("backend,interpret", [("cpu", True), ("gpu", False)])
def test_route_selection(monkeypatch, backend, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert mk.interpret_mode() is interpret


def test_route_selection_rejects_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no route"):
        mk.interpret_mode()


@pytest.mark.parametrize("precision", [jax.lax.Precision.DEFAULT,
                                       jax.lax.Precision.HIGHEST])
def test_gpu_route_lowers_to_triton(monkeypatch, csg_params, precision):
    """On the GPU the kernel is a Triton custom call (no interpret mode):
    lower the march for CUDA from the CPU and look for it."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = CFG.replace(scene="many_cylinder_cut")

    def run(origin, dirs, t, budget, active):
        st = march.MarchState(t, budget, active, jnp.zeros_like(active),
                              jnp.zeros((), jnp.int32))
        return mk.march_state(csg_params, origin, dirs, st, cfg, precision=precision,
                              relax_omega=1.6, num_steps=16, return_resolve=True)

    n = 1024
    args = (jnp.zeros(3), jnp.ones((n, 3)), jnp.zeros(n), jnp.ones(n),
            jnp.ones(n, bool))
    text = jax.jit(run).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("xla.gpu.triton") == 1
    assert f"num_warps = {mk.NUM_WARPS}" in text


# ---------------------------------------------------------------------------
# Every in-kernel CSG composer pinned against the dense scene math (a wrong
# window constant in pallas/scenes.py must fail). Guards the reference scene
# library, volumeRender_kernel.cu:156-196.
# ---------------------------------------------------------------------------


def _compose_parity_points(params, scene, frame, key=0, n=4096, cyl_window=5):
    """Evaluate the row-layout composer and the dense scene fn on the same
    random points in the bounding volume; return (dense, kernel) [n]."""
    pts = jax.random.uniform(
        jax.random.key(key), (n, 3), minval=-1.2, maxval=1.2
    ).astype(jnp.float32)
    d_raw = mlp.apply_scalar(params, pts)
    compose = kscenes.compose_fn(scene, cyl_window)
    d_kernel = np.asarray(compose(pts[:, 0], pts[:, 1], pts[:, 2], d_raw, frame))

    neural = lambda p: mlp.apply_scalar(params, p)
    d_dense = np.asarray(sdf_ops.make_scene(scene, neural, frame)(pts))
    return d_dense, d_kernel


@pytest.mark.parametrize("scene,frame", [
    ("neural_tanh", 0.0),
    ("many_sphere", 17.0),
    ("many_sphere_cut", 17.0),
    ("displacement", 0.0),
])
def test_compose_fn_exact_parity(csg_params, scene, frame):
    """Exact-everywhere composers reproduce the dense scene math."""
    d_dense, d_kernel = _compose_parity_points(csg_params, scene, frame)
    np.testing.assert_allclose(d_kernel, d_dense, atol=1e-6)


@pytest.mark.parametrize("window,band_lo,n", [(5, -0.2, 8192), (3, -0.1, 16384)])
def test_compose_fn_cylinder_window_band(csg_params, window, band_lo, n):
    """many_cylinder_cut's window is exact wherever the scene distance is
    above the window's band (5x5: > -0.2, 3x3: > -0.1 — the derivation in
    pallas/scenes.py); the near band must be populated so the guarantee is
    exercised."""
    d_dense, d_kernel = _compose_parity_points(
        csg_params, "many_cylinder_cut", 0.0, n=n, cyl_window=window
    )
    band = d_dense > band_lo
    assert band.sum() > 1000, "sampling failed to populate the near band"
    np.testing.assert_allclose(d_kernel[band], d_dense[band], atol=1e-6)

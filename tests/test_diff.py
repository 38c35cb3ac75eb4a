"""Differentiable-rendering tests (BASELINE config 4: grad parity).

Validates the implicit-function gradient against (a) the unrolled-march
autodiff estimator and (b) finite differences of the pixel loss.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.diff import implicit, losses, train
from cudaneuralrender.models import mlp
from cudaneuralrender.ops import march, sdf


def test_implicit_t_analytic_sphere_radius_grad():
    """For f(p) = |p| - r along a center ray from distance 2: t*(r) = 2 - r,
    so dt/dr must be -1 exactly."""
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array([[0.0, 0.0, -1.0]])

    def t_of_r(r):
        f = lambda p: sdf.sphere(p, r)
        res = march.sphere_trace(
            lambda p: sdf.sphere(p, jax.lax.stop_gradient(r)), origin, dirs, max_steps=200
        )
        t = implicit.implicit_surface_t(f, origin, dirs, res.t)
        return jnp.sum(t)

    g = jax.grad(t_of_r)(0.9)
    np.testing.assert_allclose(float(g), -1.0, atol=1e-4)


def test_implicit_forward_value_newton_refines():
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array([[0.0, 0.0, -1.0]])
    f = lambda p: sdf.sphere(p, 0.9)
    res = march.sphere_trace(f, origin, dirs, max_steps=200, march_eps=1e-4)
    t = implicit.implicit_surface_t(f, origin, dirs, res.t)
    # Newton step lands closer to the true root 1.1 than the raw march t.
    assert abs(float(t[0]) - 1.1) <= abs(float(res.t[0]) - 1.1) + 1e-7
    np.testing.assert_allclose(float(t[0]), 1.1, atol=1e-6)


SMALL_CFG = cnr.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=128)


@pytest.fixture(scope="module")
def tiny_params():
    # small random SDF-ish network: init near a sphere via distillation
    params = mlp.init_mlp(jax.random.key(3), sizes=(3, 16, 16, 1))

    def sample(key, n):
        pts = jax.random.uniform(key, (n, 3), minval=-1.2, maxval=1.2)
        return pts, sdf.sphere(pts, 0.7)

    params, hist = train.fit_sdf(params, sample, steps=300, batch=2048, lr=3e-3)
    assert hist[-1] < 0.002, f"distillation failed: {hist[-1]}"
    return params


def test_render_image_diff_matches_forward(tiny_params):
    """The differentiable render's forward value must match the inference
    render (same march, Newton-refined t)."""
    a = np.asarray(implicit.render_image_diff(tiny_params, cnr.Camera(), SMALL_CFG))
    b = np.asarray(cnr.render_image(tiny_params, cnr.Camera(), SMALL_CFG))
    same_hit = (a[..., 3] > 0) == (b[..., 3] > 0)
    assert same_hit.mean() > 0.98
    mask = (a[..., 3] > 0) & (b[..., 3] > 0)
    diffs = np.abs(a[mask] - b[mask])
    # Newton refinement can move a silhouette-grazing pixel noticeably; the
    # bulk of the image must agree tightly.
    assert np.percentile(diffs, 99) < 5e-2
    assert diffs.mean() < 5e-3


def test_grad_parity_implicit_vs_finite_difference(tiny_params):
    """Implicit weight-gradient vs central finite differences — BASELINE
    config 4's acceptance check.

    FD across a *pixel loss* is contaminated by hit-mask flips at the
    silhouette (the loss is discontinuous there), so parity is checked on the
    smooth part: mean squared depth over pixels that stay hit — eroded away
    from the silhouette — with a directional derivative along a random
    parameter perturbation.
    """
    cam = cnr.Camera()
    _, hit = implicit.render_depth_diff(tiny_params, cam, SMALL_CFG)
    hit2d = np.asarray(hit).reshape(16, 16)
    # erode: keep pixels whose 4-neighborhood is fully hit (stable interior)
    stable = hit2d.copy()
    stable[1:] &= hit2d[:-1]
    stable[:-1] &= hit2d[1:]
    stable[:, 1:] &= hit2d[:, :-1]
    stable[:, :-1] &= hit2d[:, 1:]
    stable_flat = jnp.asarray(stable.reshape(-1))
    assert int(stable.sum()) > 10

    def loss(params):
        t, _ = implicit.render_depth_diff(params, cam, SMALL_CFG)
        return jnp.sum(jnp.where(stable_flat, t**2, 0.0)) / stable.sum()

    g = jax.grad(loss)(tiny_params)

    # directional derivative along a random unit direction in param space
    v = jax.tree_util.tree_map(
        lambda x: jax.random.normal(jax.random.key(11), x.shape), tiny_params
    )
    gv = sum(
        float(jnp.vdot(ga.w, va.w)) + float(jnp.vdot(ga.b, va.b))
        for ga, va in zip(g, v)
    )
    eps = 1e-4
    plus = jax.tree_util.tree_map(lambda x, d: x + eps * d, tiny_params, v)
    minus = jax.tree_util.tree_map(lambda x, d: x - eps * d, tiny_params, v)
    fd = (float(loss(plus)) - float(loss(minus))) / (2 * eps)
    assert gv == pytest.approx(fd, rel=0.05, abs=1e-5), f"directional: {gv} vs {fd}"


def test_grad_parity_vs_unrolled(tiny_params):
    """Implicit gradient direction agrees with the unrolled-march autodiff
    gradient (cosine similarity of weight grads)."""
    cam = cnr.Camera()
    target = jnp.zeros((16, 16, 4))
    cfg_unrolled = SMALL_CFG.replace(march_impl="fori", max_steps=96)

    def loss_implicit(params):
        return losses.pixel_loss(params, cam, SMALL_CFG, target)

    def loss_unrolled(params):
        img = cnr.render_image(params, cam, cfg_unrolled)
        return jnp.mean((img - target) ** 2)

    gi = jax.grad(loss_implicit)(tiny_params)
    gu = jax.grad(loss_unrolled)(tiny_params)

    flat_i = np.concatenate([np.asarray(g.w).ravel() for g in gi])
    flat_u = np.concatenate([np.asarray(g.w).ravel() for g in gu])
    cos = flat_i @ flat_u / (np.linalg.norm(flat_i) * np.linalg.norm(flat_u) + 1e-12)
    assert cos > 0.9, f"cosine {cos}"


def test_pixel_train_step_reduces_loss(tiny_params):
    """Inverse rendering: a few adam steps on a target image must reduce loss."""
    cam = cnr.Camera()
    target = implicit.render_image_diff(tiny_params, cam, SMALL_CFG)
    # perturb the params, then recover
    noisy = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(7), x.shape), tiny_params
    )
    state = train.init_train_state(noisy, lr=1e-3)
    losses_seq = []
    for _ in range(25):
        state, l = train.pixel_train_step(state, cam, target, SMALL_CFG, lr=1e-3)
        losses_seq.append(float(l))
    # adam on a discontinuous-at-silhouette objective oscillates; require the
    # best iterate to improve substantially on the start.
    assert min(losses_seq) < 0.85 * losses_seq[0], losses_seq


def test_eikonal_and_silhouette_losses_finite(tiny_params):
    pts = jax.random.uniform(jax.random.key(1), (256, 3), minval=-1, maxval=1)
    e = float(losses.eikonal_loss(tiny_params, pts))
    assert np.isfinite(e) and e >= 0
    mask = jnp.zeros((16, 16), bool)
    s = float(losses.silhouette_loss(tiny_params, cnr.Camera(), SMALL_CFG, mask))
    assert np.isfinite(s)
    g = jax.grad(lambda p: losses.silhouette_loss(p, cnr.Camera(), SMALL_CFG, mask))(tiny_params)
    assert all(np.isfinite(np.asarray(x.w)).all() for x in g)


# ---------------------------------------------------------------------------
# Fast surface solve (diff/solve.py) wired into the differentiable path
# (round-2 VERDICT item 1: the staged scheduler as the grad step's t*-solver)
# ---------------------------------------------------------------------------

from cudaneuralrender.diff import solve  # noqa: E402

FULL_CFG = cnr.RenderConfig(
    width=64, height=64, scene="neural_raw", max_steps=256,
    march_precision="full",
)
MIXED_CFG = FULL_CFG.replace(march_precision="mixed")


def _grad_flat(g):
    return np.concatenate(
        [np.asarray(x).ravel() for l in g for x in (l.w, l.b)]
    )


def test_solve_surface_full_matches_dense(tiny_params):
    """march_precision='full': the staged solve must agree with the dense
    exact march (reference-ordered stepping) — isolated silhouette budget
    ties at most."""
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    stats = {}
    t_fast, hit_fast = solve.solve_surface(
        tiny_params, cam, FULL_CFG, stats_out=stats
    )
    t_dense, hit_dense = solve._solve_dense(
        tiny_params, cam, FULL_CFG, jnp.float32(0.0)
    )
    hf, hd = np.asarray(hit_fast), np.asarray(hit_dense)
    assert (hf != hd).mean() <= 1e-3
    both = hf & hd
    assert both.sum() > 100
    np.testing.assert_allclose(
        np.asarray(t_fast)[both], np.asarray(t_dense)[both], atol=1e-5
    )
    assert stats["rays"] == FULL_CFG.num_rays


def test_solve_surface_mixed_close_to_dense(tiny_params):
    """Mixed-precision staged solve vs the dense march, compared where it
    matters for the diff path: after the implicit step's Newton refinement
    (raw converged t's legitimately differ on this sloppy toy SDF — the
    plain dense march oversteps inside the non-Lipschitz field while the
    staged relaxed march backtracks; one Newton step collapses both onto
    the same root)."""
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    t_fast, hit_fast = solve.solve_surface(tiny_params, cam, MIXED_CFG)
    t_dense, hit_dense = solve._solve_dense(
        tiny_params, cam, MIXED_CFG, jnp.float32(0.0)
    )
    hf, hd = np.asarray(hit_fast), np.asarray(hit_dense)
    assert (hf != hd).mean() <= 0.01
    both = hf & hd
    assert both.sum() > 100

    from cudaneuralrender.ops import camera as camera_lib
    from cudaneuralrender.render.renderer import scene_fn

    c2w, _ = camera_lib.view_matrices(cam)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, MIXED_CFG.focal)
    f = scene_fn(tiny_params, MIXED_CFG, 0.0)
    tn_fast = np.asarray(implicit.implicit_surface_t(f, origin, dirs, t_fast))
    tn_dense = np.asarray(implicit.implicit_surface_t(f, origin, dirs, t_dense))
    dn = np.abs(tn_fast - tn_dense)[both]
    assert np.percentile(dn, 50) < 1e-5
    assert np.percentile(dn, 99) < 2e-3


def test_grad_fast_solve_matches_dense(tiny_params):
    """pixel_loss grads from the precomputed full-precision solve equal the
    in-trace dense-march grads (the solve is gradient-severed either way)."""
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    target = jnp.zeros((64, 64, 4))
    t_star, hit = solve.solve_surface(tiny_params, cam, FULL_CFG)

    g_fast = jax.grad(
        lambda p: losses.pixel_loss(
            p, cam, FULL_CFG, target, t_star=t_star, hit=hit
        )
    )(tiny_params)
    g_dense = jax.grad(
        lambda p: losses.pixel_loss(p, cam, FULL_CFG, target)
    )(tiny_params)

    a, b = _grad_flat(g_fast), _grad_flat(g_dense)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.9999, f"cosine {cos}"
    assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b) + 1e-9


def test_render_image_diff_rejects_half_solve(tiny_params):
    with pytest.raises(ValueError):
        implicit.render_image_diff(
            tiny_params, cnr.Camera(), SMALL_CFG,
            t_star=jnp.zeros(SMALL_CFG.num_rays),
        )


def test_pixel_train_step_fast_reduces_loss(tiny_params):
    """Inverse rendering through the staged solve: loss decreases, matching
    the dense-step test's acceptance."""
    cam = cnr.Camera()
    target = implicit.render_image_diff(tiny_params, cam, SMALL_CFG)
    noisy = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(7), x.shape),
        tiny_params,
    )
    state = train.init_train_state(noisy, lr=1e-3)
    losses_seq = []
    for _ in range(25):
        state, l = train.pixel_train_step_fast(
            state, cam, target, SMALL_CFG, lr=1e-3
        )
        losses_seq.append(float(l))
    assert min(losses_seq) < 0.85 * losses_seq[0], losses_seq


def test_train_state_checkpoint_resume(tmp_path, plane1_params):
    """save_train_state/load_train_state round-trip: resuming from a
    checkpoint must continue training bit-identically to an uninterrupted
    run (weights, adam moments, and step counter all restored)."""
    import jax
    import jax.numpy as jnp
    from cudaneuralrender.diff import train

    def sample_fn(key, n):
        pts = jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0)
        return pts, jnp.linalg.norm(pts, axis=-1) - 0.5

    lr = 1e-3
    state = train.init_train_state(plane1_params, lr)
    key = jax.random.key(0)
    for i in range(3):
        key, sub = jax.random.split(key)
        pts, d = sample_fn(sub, 256)
        state, _ = train.sdf_train_step(state, pts, d, lr)

    path = str(tmp_path / "ckpt.npz")
    train.save_train_state(path, state)
    resumed = train.load_train_state(
        path, train.init_train_state(plane1_params, lr))
    assert int(resumed.step) == 3

    key_a = key_b = key
    cont, res = state, resumed
    for i in range(2):
        key_a, sub = jax.random.split(key_a)
        pts, d = sample_fn(sub, 256)
        cont, loss_a = train.sdf_train_step(cont, pts, d, lr)
        res, loss_b = train.sdf_train_step(res, pts, d, lr)
        assert float(loss_a) == float(loss_b)
    for a, b in zip(jax.tree_util.tree_leaves(cont), jax.tree_util.tree_leaves(res)):
        import numpy as np
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_train_state_shape_mismatch(tmp_path, plane1_params):
    from cudaneuralrender.diff import train
    import pytest

    state = train.init_train_state(plane1_params, 1e-3)
    path = str(tmp_path / "ckpt.npz")
    train.save_train_state(path, state)
    # template with a different model shape must be rejected
    import jax.numpy as jnp
    bad_params = jax.tree_util.tree_map(
        lambda a: jnp.zeros((3, 3), a.dtype) if a.ndim == 2 else a, plane1_params)
    with pytest.raises(ValueError):
        train.load_train_state(path, train.init_train_state(bad_params, 1e-3))


def test_pixel_loss_compact_matches_dense(plane1_params):
    """The compacted-bucket pixel loss (compact_cap) must equal the dense
    formula in value and in weight-gradients: only hit rays carry gradient,
    and the background residual is a constant summed densely."""
    import jax
    import jax.numpy as jnp
    from cudaneuralrender.diff import losses
    from cudaneuralrender.diff.solve import solve_surface

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged")
    cam = cnr.Camera(rotation_y=30.0)
    key = jax.random.key(1)
    target = jax.random.uniform(key, (32, 32, 4))

    t_star, hit = solve_surface(plane1_params, cam, cfg)
    n_hits = int(jnp.sum(hit))
    assert n_hits > 10
    cap = 256
    assert cap >= n_hits

    dense_loss, dense_g = jax.value_and_grad(losses.pixel_loss)(
        plane1_params, cam, cfg, target, t_star=t_star, hit=hit)
    comp_loss, comp_g = jax.value_and_grad(losses.pixel_loss)(
        plane1_params, cam, cfg, target, t_star=t_star, hit=hit,
        compact_cap=cap)

    np.testing.assert_allclose(float(comp_loss), float(dense_loss),
                               rtol=1e-5, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(dense_g),
                    jax.tree_util.tree_leaves(comp_g)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-7)


def test_pixel_train_step_fast_uses_compact_bucket(plane1_params):
    """pixel_train_step_fast must run (and reduce loss) through the
    compacted grad path end-to-end."""
    import jax.numpy as jnp
    from cudaneuralrender.diff import train
    from cudaneuralrender.render import renderer

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=300, march_impl="staged",
                           compact_min=64)
    cam = cnr.Camera(rotation_y=30.0)
    target = jnp.asarray(np.asarray(
        renderer.render_staged(plane1_params, cam, cfg.replace(rgba_packed=False))))
    # start from perturbed weights so there is a gradient signal to descend
    import jax
    perturbed = jax.tree_util.tree_map(
        lambda a: a * (1.0 + 0.02 * jnp.cos(jnp.arange(a.size, dtype=jnp.float32)
                                            ).reshape(a.shape)),
        plane1_params)
    state = train.init_train_state(perturbed, 1e-3)
    stats = {}
    losses_seq = []
    for _ in range(6):
        state, loss = train.pixel_train_step_fast(
            state, cam, target, cfg, 1e-3, stats_out=stats)
        losses_seq.append(float(loss))
    assert min(losses_seq[1:]) < losses_seq[0]


def test_train_loop_fast_matches_sequential(plane1_params):
    """Pipelined multi-step training (train_loop_fast, deferred checks) must
    reproduce the sequential pixel_train_step_fast trajectory: same losses,
    same final weights — pipelining only reorders host fetches, never
    device math."""
    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cams = [cnr.Camera(rotation_y=20.0 + 2 * i) for i in range(4)]
    target = jnp.asarray(np.asarray(cnr.render_image(
        plane1_params, cnr.Camera(rotation_y=24.0),
        cfg.replace(march_impl="while"))))

    s0 = train.init_train_state(plane1_params, lr=1e-3)
    seq_state, seq_losses, st = s0, [], {}
    for cam in cams:
        seq_state, loss = train.pixel_train_step_fast(
            seq_state, cam, target, cfg, 1e-3, stats_out=st)
        seq_losses.append(float(loss))

    stats_list = []
    loop_state, loop_losses = train.train_loop_fast(
        s0, cams, target, cfg, 1e-3, stats_out=stats_list)

    np.testing.assert_allclose(loop_losses, seq_losses, rtol=1e-6)
    assert len(stats_list) == 4
    for a, b in zip(jax.tree_util.tree_leaves(loop_state.params),
                    jax.tree_util.tree_leaves(seq_state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_train_loop_fast_overflow_redo(plane1_params):
    """A mid-loop fast-path failure (tiny refine buckets) must roll back
    and redo synchronously — the loop's losses still track the sequential
    trajectory within the widened-schedule tolerance."""
    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train

    cnr.reset_schedule_memo()
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           compact_min=8,
                           refine_schedule=((1024, 4), (1024, 0)),
                           coarse_pallas=False, refine_pallas=False)
    cams = [cnr.Camera(rotation_y=20.0 + 2 * i) for i in range(3)]
    target = jnp.zeros((32, 32, 4), jnp.float32)
    s0 = train.init_train_state(plane1_params, lr=1e-3)
    state, losses_out = train.train_loop_fast(s0, cams, target, cfg, 1e-3)
    assert len(losses_out) == 3
    assert all(np.isfinite(l) for l in losses_out)
    cnr.reset_schedule_memo()


def test_pixel_loss_packed_matches_compact(plane1_params):
    """The packed-bundle grad path (losses.pixel_loss_packed, fed by
    solve_surface_packed_async — both big sorts cancelled) must produce the
    same loss and gradients as the image-order compact path."""
    import cudaneuralrender as cnr
    from cudaneuralrender.diff import losses
    from cudaneuralrender.diff.solve import (
        solve_surface, solve_surface_packed_async,
    )
    from cudaneuralrender.ops import compaction
    from cudaneuralrender.render.renderer import _conv_within

    # compact_min small enough that the first refine bucket is a real
    # prefix at 32x32 (within-bound exists -> the packed path engages)
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           compact_min=64,
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=20.0)
    target = jnp.asarray(np.asarray(cnr.render_image(
        plane1_params, cnr.Camera(rotation_y=24.0),
        cfg.replace(march_impl="while"))))

    t_star, hit = solve_surface(plane1_params, cam, cfg)
    hits = int(jnp.sum(hit))
    n = cfg.num_rays
    cap = compaction.capacity_pow2_of(hits, n, minimum=cfg.compact_min)
    within = _conv_within(cfg)
    assert within is not None

    pos, t_p, conv, w_bound, check = solve_surface_packed_async(
        plane1_params, cam, cfg)
    assert check()
    assert w_bound == within

    loss_a, g_a = jax.value_and_grad(
        lambda p: losses.pixel_loss(p, cam, cfg, target, t_star=t_star,
                                    hit=hit, compact_cap=min(cap, n - 1)))(
        plane1_params)
    loss_b, g_b = jax.value_and_grad(
        lambda p: losses.pixel_loss_packed(p, cam, cfg, target, pos, t_p,
                                           conv, min(cap, within), w_bound))(
        plane1_params)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-5)
    la, lb = jax.tree_util.tree_leaves(g_a), jax.tree_util.tree_leaves(g_b)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-8)


def test_pixel_train_step_fast_uses_packed_path(plane1_params):
    """pixel_train_step_fast's pipelined mode (and train_loop_fast) produce
    the same training trajectory whether the packed handoff is active
    (mixed precision) or not — covered by comparing consecutive fast steps
    to the known-good first synchronous step trajectory."""
    import cudaneuralrender as cnr
    from cudaneuralrender.diff import train

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=20.0)
    target = jnp.asarray(np.asarray(cnr.render_image(
        plane1_params, cnr.Camera(rotation_y=24.0),
        cfg.replace(march_impl="while"))))
    from cudaneuralrender.render.renderer import _conv_within

    # compact_min small enough that the within-bound exists at 32x32, so
    # the second (pipelined) step MUST take the packed branch
    cfg = cfg.replace(compact_min=64)
    assert _conv_within(cfg) is not None
    s0 = train.init_train_state(plane1_params, lr=1e-3)
    st: dict = {}
    s1, l1 = train.pixel_train_step_fast(s0, cam, target, cfg, 1e-3,
                                         stats_out=st)
    s2, l2 = train.pixel_train_step_fast(s1, cam, target, cfg, 1e-3,
                                         stats_out=st)  # pipelined+packed
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    # the deferred check must certify the packed fast path actually ran
    assert st.get("fast_path") is True, st

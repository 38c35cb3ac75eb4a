"""SDF primitive / CSG operator tests vs closed-form values.

Covers the reference's device SDF library (volumeRender_kernel.cu:63-230).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from cudaneuralrender.ops import sdf


def test_sphere():
    p = jnp.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    d = sdf.sphere(p, 1.0)
    np.testing.assert_allclose(np.asarray(d), [-1.0, 1.0, 0.0], atol=1e-6)


def test_box():
    p = jnp.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 2.0, 0.0]])
    d = sdf.box(p, (1.0, 1.0, 1.0))
    want = [-1.0, 1.0, np.sqrt(2.0)]
    np.testing.assert_allclose(np.asarray(d), want, atol=1e-6)


def test_box_rounded():
    p = jnp.array([[2.0, 0.0, 0.0]])
    np.testing.assert_allclose(np.asarray(sdf.box(p, (1.0, 1.0, 1.0), 0.25)), [0.75], atol=1e-6)


def test_plane():
    p = jnp.array([[0.0, 0.5, 0.0], [0.0, 1.5, 0.0]])
    np.testing.assert_allclose(np.asarray(sdf.plane(p)), [0.0, 1.0], atol=1e-6)


def test_cylinder_reference_convention():
    """Reference quirk (:96-101): distance uses (p.x, p.y) vs (c.x, c.z), radius c.y."""
    c = jnp.array([0.0, 0.5, 0.0])
    p = jnp.array([[1.0, 0.0, 99.0]])  # z must not matter
    np.testing.assert_allclose(np.asarray(sdf.cylinder(p, c)), [0.5], atol=1e-6)


def test_csg_ops():
    d1 = jnp.array([0.3])
    d2 = jnp.array([-0.1])
    np.testing.assert_allclose(np.asarray(sdf.union(d1, d2)), [-0.1])
    np.testing.assert_allclose(np.asarray(sdf.intersect(d1, d2)), [0.3])
    np.testing.assert_allclose(np.asarray(sdf.subtract(d1, d2)), [0.3])
    np.testing.assert_allclose(np.asarray(sdf.round_op(d1, 0.1)), [0.2], atol=1e-7)
    np.testing.assert_allclose(np.asarray(sdf.onion(d2, 0.05)), [0.05], atol=1e-7)


def test_smooth_union_far_apart_equals_min():
    """With |d1-d2| >> k the smooth blend reduces to plain min/max."""
    d1, d2 = jnp.array([1.0]), jnp.array([0.1])
    np.testing.assert_allclose(np.asarray(sdf.smooth_union(d1, d2, 0.01)), [0.1], atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sdf.smooth_subtract(d1, d2, 0.01)), [1.0], atol=1e-6
    )


def test_smooth_union_equal_inputs_dips():
    """At d1 == d2 the polynomial blend dips by k/4 below min."""
    d = jnp.array([0.5])
    got = float(sdf.smooth_union(d, d, 0.2)[0])
    assert got == pytest.approx(0.5 - 0.2 * 0.25, abs=1e-6)


def test_displace_bounds():
    p = jnp.array([[0.3, 0.4, 0.5]])
    d = jnp.array([0.0])
    got = float(sdf.displace(p, d)[0])
    assert abs(got) <= 0.05 + 1e-6
    want = 0.05 * np.sin(1.5) * np.sin(2.0) * np.sin(2.5)
    assert got == pytest.approx(want, abs=1e-6)


def test_many_sphere_centers_match_loop():
    """Re-derive the 9 sphere centers with a literal transcription of the
    reference loop (volumeRender_kernel.cu:176-196) and compare."""
    centers = []
    x_off, y_off = 0.0, -0.6
    for i in range(9):
        if i % 3 == 0:
            y_off += 0.4
            x_off = 0.5
        centers.append((-x_off, -y_off, 0.7))  # world center = -offset, z at frame 0
        x_off -= 0.4
    from cudaneuralrender.ops.sdf import _MANY_SPHERE_CENTERS

    got = _MANY_SPHERE_CENTERS.copy()
    got[:, 2] = 0.7  # frame-0 z handled inside many_sphere
    np.testing.assert_allclose(got, np.asarray(centers, np.float32), atol=1e-6)


def test_many_sphere_scene_dips_at_sphere_center():
    """At a sphere center the scene SDF must be ~ -0.1 regardless of the
    neural value (union picks the sphere)."""
    neural = lambda p: jnp.full(p.shape[:-1], 10.0)  # far away
    scene = sdf.make_scene("many_sphere", neural, frame=0.0)
    center = jnp.array([[-0.5, -0.2, 0.7]])
    got = float(scene(center)[0])
    assert got == pytest.approx(-0.1, abs=1e-3)


def test_many_sphere_animation_moves_z():
    neural = lambda p: jnp.full(p.shape[:-1], 10.0)
    s0 = sdf.make_scene("many_sphere", neural, frame=0.0)
    s180 = sdf.make_scene("many_sphere", neural, frame=180.0)
    # at frame 180 the z offset is -0.7 + 180*2*0.7/360 = 0 -> centers at z=0
    center = jnp.array([[-0.5, -0.2, 0.0]])
    assert float(s180(center)[0]) == pytest.approx(-0.1, abs=1e-3)
    assert float(s0(center)[0]) > 0.0


def test_scene_registry():
    neural = lambda p: sdf.sphere(p, 0.5)
    for name in ["neural_raw", "neural_tanh", "many_sphere", "many_sphere_cut",
                 "many_cylinder_cut", "displacement", "sphere"]:
        scene = sdf.make_scene(name, neural)
        d = scene(jnp.zeros((4, 3)))
        assert d.shape == (4,)
    with pytest.raises(ValueError):
        sdf.make_scene("nope", neural)
    with pytest.raises(ValueError):
        sdf.make_scene("neural_raw", None)


def test_neural_tanh_squashes():
    neural = lambda p: jnp.full(p.shape[:-1], 3.0)
    scene = sdf.make_scene("neural_tanh", neural)
    np.testing.assert_allclose(np.asarray(scene(jnp.zeros((1, 3)))), [np.tanh(3.0)], atol=1e-6)


def test_many_cylinder_cut_windowed_surface_band(plane1_params):
    """The windowed dense compose (ops/sdf.many_cylinder_cut_windowed) must
    equal the complete 300-term scan wherever the scene distance is above
    the window band (window 3: > -0.1) — the only region shading/gradient
    consumers evaluate (points sit on the surface)."""
    import jax

    from cudaneuralrender.models import mlp

    pts = jax.random.uniform(
        jax.random.key(3), (16384, 3), minval=-1.2, maxval=1.2
    ).astype(jnp.float32)
    d_raw = mlp.apply_scalar(plane1_params, pts)
    full = np.asarray(sdf.many_cylinder_cut(pts, d_raw))
    for window, band in ((3, -0.1), (5, -0.2)):
        win = np.asarray(sdf.many_cylinder_cut_windowed(pts, d_raw, window))
        mask = full > band
        assert mask.sum() > 1000
        np.testing.assert_allclose(win[mask], full[mask], atol=1e-6)

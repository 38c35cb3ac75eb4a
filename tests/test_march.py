"""Sphere-trace tests vs analytic ray-sphere geometry.

The march loop is validated against closed-form intersections of an analytic
sphere SDF — mirroring the role of the reference's golden-image eyeballing
but machine-checked.
"""
import numpy as np
import jax
import jax.numpy as jnp

from cudaneuralrender.ops import march, sdf


def _axis_rays():
    """A few rays with known geometry vs a unit-0.9 sphere at the origin."""
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array(
        [
            [0.0, 0.0, -1.0],   # straight through center: hit at t=1.1
            [0.0, 1.0, 0.0],    # perpendicular: misses bounding sphere
            [0.0, 0.0, 1.0],    # away from scene: misses
        ]
    )
    return origin, dirs


def test_intersect_sphere_analytic():
    origin, dirs = _axis_rays()
    tnear, tfar, hit = march.intersect_sphere(origin, dirs, (0.0, 0.0, 0.0), 1.2)
    # Parity with intersectSphere (:201-215): 'hit' is true whenever the
    # *line* intersects — a ray pointing away (ray 2) reports hit with a
    # negative tfar, and is culled by the budget on the first march step.
    np.testing.assert_array_equal(np.asarray(hit), [True, False, True])
    np.testing.assert_allclose(float(tnear[0]), 2.0 - 1.2, atol=1e-5)
    np.testing.assert_allclose(float(tfar[0]), 2.0 + 1.2, atol=1e-5)
    assert float(tfar[2]) < 0.0  # behind the origin -> budget-culled


def test_sphere_trace_hits_at_analytic_distance():
    origin, dirs = _axis_rays()
    f = lambda p: sdf.sphere(p, 0.9)
    res = march.sphere_trace(f, origin, dirs, max_steps=200, march_eps=1e-6)
    assert bool(res.hit[0])
    assert not bool(res.hit[1])
    assert not bool(res.hit[2])
    # surface at t = 2.0 - 0.9 = 1.1
    np.testing.assert_allclose(float(res.t[0]), 1.1, atol=1e-4)


def test_sphere_trace_inside_bound_miss_background():
    """A ray entering the bounding sphere but missing the shape must exhaust
    its budget and end not-hit (reference :463-467)."""
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array([[0.5, 0.5, -1.0]])
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    f = lambda p: sdf.sphere(p, 0.2)  # tiny sphere, this ray misses it
    res = march.sphere_trace(f, origin, dirs, max_steps=500)
    assert not bool(res.hit[0])
    assert not bool(res.active[0])  # resolved by budget, not step cap


def test_while_and_unrolled_agree():
    origin = jnp.array([0.0, 0.0, 2.0])
    k = 17
    angles = jnp.linspace(-0.4, 0.4, k)
    dirs = jnp.stack([jnp.sin(angles), jnp.zeros(k), -jnp.cos(angles)], axis=-1)
    f = lambda p: sdf.sphere(p, 0.9)
    a = march.sphere_trace(f, origin, dirs, max_steps=300)
    b = march.sphere_trace_unrolled(f, origin, dirs, num_steps=300)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), atol=1e-6)


def test_march_stage_equals_full_march():
    """Chaining march_stage segments must equal one sphere_trace."""
    origin = jnp.array([0.0, 0.0, 2.0])
    k = 9
    angles = jnp.linspace(-0.4, 0.4, k)
    dirs = jnp.stack([jnp.sin(angles), jnp.zeros(k), -jnp.cos(angles)], axis=-1)
    f = lambda p: sdf.sphere(p, 0.9)

    full = march.sphere_trace(f, origin, dirs, max_steps=300)

    state = march.init_state(origin, dirs, (0.0, 0.0, 0.0), 1.2)
    for _ in range(30):
        state = march.march_stage(
            f, origin, dirs, state, num_steps=10, max_steps=300, march_eps=1e-6
        )
    np.testing.assert_array_equal(np.asarray(full.hit), np.asarray(state.converged))
    np.testing.assert_allclose(np.asarray(full.t), np.asarray(state.t), atol=1e-6)


def test_early_exit_step_count():
    """while_loop must exit as soon as all rays resolve, not run max_steps."""
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array([[0.0, 0.0, -1.0]])
    f = lambda p: sdf.sphere(p, 0.9)
    res = march.sphere_trace(f, origin, dirs, max_steps=6000)
    assert int(res.steps) < 100


def test_jit_and_grad_through_unrolled():
    origin = jnp.array([0.0, 0.0, 2.0])
    dirs = jnp.array([[0.0, 0.0, -1.0]])

    def loss(radius):
        f = lambda p: sdf.sphere(p, radius)
        res = march.sphere_trace_unrolled(f, origin, dirs, num_steps=64)
        return jnp.sum(res.t)

    g = jax.grad(loss)(0.9)
    # t_hit = 2 - radius -> dt/dr = -1
    np.testing.assert_allclose(float(g), -1.0, atol=1e-3)


def test_relaxed_march_matches_plain():
    """Over-relaxed sphere tracing (march_stage_relaxed) must find exactly the
    same hit set as plain stepping on a Lipschitz SDF, in fewer iterations,
    with hit positions within a few eps of the surface. Grazing rays (near
    the silhouette at asin(0.45)=0.4668 rad) are where the deep-step tail
    lives and where relaxation pays; head-on rays converge in a handful of
    steps either way (and can even oscillate once under relaxation)."""
    origin = jnp.array([0.0, 0.0, 2.0])
    k = 41
    angles = jnp.linspace(0.40, 0.4665, k)
    dirs = jnp.stack([jnp.sin(angles), jnp.zeros(k), -jnp.cos(angles)], axis=-1)
    f = lambda p: sdf.sphere(p, 0.9)

    st0 = march.init_state(origin, dirs, (0.0, 0.0, 0.0), 1.2)
    plain = march.march_stage(
        f, origin, dirs, st0, num_steps=2000, max_steps=2000, march_eps=1e-6
    )
    rel = march.march_stage(
        f, origin, dirs, st0, num_steps=2000, max_steps=2000, march_eps=1e-6,
        relax_omega=1.6,
    )
    np.testing.assert_array_equal(
        np.asarray(plain.converged), np.asarray(rel.converged)
    )
    assert int(rel.steps) < int(plain.steps)
    both = np.asarray(plain.converged)
    # both land within ~eps-scale of the analytic sphere hit t = 2cos - sqrt(...)
    d = np.abs(np.asarray(plain.t) - np.asarray(rel.t))[both]
    assert d.max() < 1e-4


def test_relaxed_budget_miss_parity():
    """Rays that exhaust their budget must miss under relaxation too (the
    budget decrements by distance actually traveled, backtracks refund)."""
    origin = jnp.array([0.0, 0.0, 2.0])
    # grazing ray that never hits: closest approach 2*sin(0.48) = 0.923 > 0.9
    dirs = jnp.array([[jnp.sin(0.48), 0.0, -jnp.cos(0.48)]], dtype=jnp.float32)
    f = lambda p: sdf.sphere(p, 0.9)
    st0 = march.init_state(origin, dirs, (0.0, 0.0, 0.0), 1.2)
    plain = march.march_stage(
        f, origin, dirs, st0, num_steps=4000, max_steps=4000, march_eps=1e-6
    )
    rel = march.march_stage(
        f, origin, dirs, st0, num_steps=4000, max_steps=4000, march_eps=1e-6,
        relax_omega=1.6,
    )
    assert not bool(plain.converged[0]) and not bool(rel.converged[0])
    assert not bool(plain.active[0]) and not bool(rel.active[0])

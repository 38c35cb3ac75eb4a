"""Cone-traced low-res prepass (ops/prepass.py): conservative start depths
(never past the surface), sky culling, and staged-path equivalence."""
import numpy as np
import jax.numpy as jnp

import cudaneuralrender as cnr
from cudaneuralrender.ops import camera as cam_lib
from cudaneuralrender.ops import march, prepass, sdf


def _setup(res=32, ry=30.0):
    cam_to_world, _ = cam_lib.view_matrices(cnr.Camera(rotation_y=ry))
    return cam_lib.generate_rays(cam_to_world, res, res, 2.0)


def test_prepass_start_depths_are_safe():
    f = lambda p: sdf.sphere(p, 0.7)
    origin, dirs = _setup(32)
    st = prepass.prepass_init(f, origin, dirs, 32, 32, 4, margin=0.01,
                              bound_center=(0, 0, 0), bound_radius=1.2)
    pts = np.asarray(origin + dirs * st.t[:, None])
    d = np.asarray(f(jnp.asarray(pts)))
    active = np.asarray(st.active)
    # every surviving ray starts strictly outside the surface
    assert np.all(d[active] > 0.0)
    # and made progress past the bounding sphere entry
    base = march.init_state(origin, dirs, (0, 0, 0), 1.2)
    gained = np.asarray(st.t - base.t)
    assert gained[active].mean() > 0.05


def test_prepass_kills_sky_neighborhoods():
    # Needs realistic resolution: the cone radius scales with the low-res
    # grid spacing, so sky culling only engages when cones are thin.
    f = lambda p: sdf.sphere(p, 0.3)  # small sphere, lots of sky
    origin, dirs = _setup(128)
    base = march.init_state(origin, dirs, (0, 0, 0), 1.2)
    st = prepass.prepass_init(f, origin, dirs, 128, 128, 4, margin=0.01,
                              bound_center=(0, 0, 0), bound_radius=1.2)
    n_base = int(np.asarray(base.active).sum())
    n_pre = int(np.asarray(st.active).sum())
    assert n_pre < n_base  # sky rays inside the bounding sphere got culled
    # no ray that ultimately hits was culled: march both to completion
    ref = march.sphere_trace(f, origin, dirs, max_steps=500, march_eps=1e-6)
    culled = np.asarray(base.active) & ~np.asarray(st.active)
    assert not np.any(np.asarray(ref.hit) & culled)


def test_staged_prepass_on_off_match(plane1_params):
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=400, march_impl="staged")
    cam = cnr.Camera(rotation_y=40.0, rotation_x=10.0)
    on = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    off = np.asarray(cnr.render_staged(plane1_params, cam,
                                       cfg.replace(prepass_factor=0)))
    hit_on = on[..., 3] > 0
    hit_off = off[..., 3] > 0
    agree = (hit_on == hit_off).mean()
    assert agree >= 0.99, f"hit agreement {agree}"


def test_prepass_skipped_when_not_divisible(plane1_params):
    # 30 not divisible by 4: prepass must silently disable, not crash
    cfg = cnr.RenderConfig(width=30, height=30, scene="neural_raw",
                           max_steps=200, march_impl="staged")
    img = np.asarray(cnr.render_staged(plane1_params, cnr.Camera(), cfg))
    assert np.isfinite(img).all()

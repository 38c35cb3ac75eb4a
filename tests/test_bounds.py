"""Auto-fitted bounding sphere (ops/bounds.py).

The reference hardcodes r=1.2 (volumeRender_kernel.cu:325-328); the fitter
probes the scene SDF and returns the smallest covering sphere (+margins),
never larger than the base bound. On the shipped geometries the surface
genuinely reaches |p|~1.1, so the fit stays ~1.2 there — the analytic
sphere scene is the meaningful shrink case.
"""
import numpy as np

import cudaneuralrender as cnr
from cudaneuralrender.render import renderer


def test_fit_analytic_sphere_shrinks():
    cfg = cnr.RenderConfig(scene="sphere")
    f = renderer.scene_fn(None, cfg, 0.0)
    center, radius = cnr.fit_bound_sphere(f, cfg.bound_center, cfg.bound_radius)
    # analytic sphere: r=0.9 at origin; fit must cover it with margin
    assert np.linalg.norm(center) < 0.1
    assert 0.9 < radius < 1.2


def test_fit_never_exceeds_base(plane1_params):
    cfg = cnr.RenderConfig(scene="neural_raw")
    f = renderer.scene_fn(plane1_params, cfg, 0.0)
    center, radius = cnr.fit_bound_sphere(f, cfg.bound_center, cfg.bound_radius)
    assert radius <= cfg.bound_radius + 1e-6
    # fitted bound must still contain every hit of a render using it
    tight = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300,
                             bound_center=center, bound_radius=radius)
    base = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=300)
    a = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), tight))
    b = np.asarray(cnr.render_image(plane1_params, cnr.Camera(), base))
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() > 0.99

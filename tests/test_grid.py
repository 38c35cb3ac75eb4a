"""Baked-distance-grid empty-space skipping (ops/grid.py): interpolation
accuracy, conservative stepping (never crosses the surface), and staged-path
equivalence with the grid phase on/off."""
import numpy as np
import jax
import jax.numpy as jnp

import cudaneuralrender as cnr
from cudaneuralrender.ops import grid, march, sdf


BOUND = 1.26


def _sphere(p):
    return sdf.sphere(p, 0.7)


def test_bake_samples_cell_centers():
    g = grid.bake(_sphere, 32, BOUND)
    assert g.shape == (32, 32, 32)
    # center cell is deep inside the sphere, corner far outside
    mid = 32 // 2
    assert float(g[mid, mid, mid]) < -0.5
    assert float(g[0, 0, 0]) > 0.5


def test_trilinear_matches_field():
    g = grid.bake(_sphere, 64, BOUND)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-1.1, 1.1, size=(500, 3)).astype(np.float32))
    got = np.asarray(grid.trilinear(g, pts, BOUND))
    want = np.asarray(_sphere(pts))
    # 1-Lipschitz field: interp error bounded by ~half cell diagonal
    cell_diag = (2 * BOUND / 64) * np.sqrt(3)
    assert np.abs(got - want).max() < cell_diag


def test_grid_march_never_crosses_surface():
    g = grid.bake(_sphere, 32, BOUND)
    cam_to_world, _ = __import__(
        "cudaneuralrender.ops.camera", fromlist=["view_matrices"]
    ).view_matrices(cnr.Camera(rotation_y=30.0))
    from cudaneuralrender.ops import camera as cam_lib

    origin, dirs = cam_lib.generate_rays(cam_to_world, 16, 16, 2.0)
    st = march.init_state(origin, dirs, (0, 0, 0), 1.2)
    out = grid.grid_march(g, origin, dirs, st, bound=BOUND, max_steps=6000)
    pts = np.asarray(origin + dirs * out.t[:, None])
    d = np.asarray(_sphere(jnp.asarray(pts)))
    active = np.asarray(out.active)
    # every still-active ray sits strictly OUTSIDE the surface
    assert np.all(d[active] > 0.0)
    # rays pointed at the sphere made real progress (moved beyond tnear)
    t0 = np.asarray(st.t)
    moved = np.asarray(out.t) - t0
    assert moved[active].max() > 0.1


def test_staged_render_grid_on_off_match(plane1_params):
    cfg = cnr.RenderConfig(width=24, height=24, scene="neural_raw",
                           max_steps=400, march_impl="staged")
    cam = cnr.Camera(rotation_y=40.0, rotation_x=10.0)
    on = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    off = np.asarray(cnr.render_staged(plane1_params, cam, cfg.replace(grid_res=0)))
    hit_on = on[..., 3] > 0
    hit_off = off[..., 3] > 0
    agree = (hit_on == hit_off).mean()
    assert agree >= 0.99, f"hit agreement {agree}"
    both = hit_on & hit_off
    np.testing.assert_allclose(on[both], off[both], atol=1e-3)


def test_full_precision_ignores_grid(plane1_params):
    cfg = cnr.RenderConfig(width=16, height=16, scene="neural_raw",
                           max_steps=300, march_impl="staged",
                           march_precision="full", rgba_packed=False)
    img = np.asarray(cnr.render_staged(plane1_params, cnr.Camera(), cfg))
    dense = np.asarray(cnr.render_image(plane1_params, cnr.Camera(),
                                        cfg.replace(march_impl="while")))
    np.testing.assert_allclose(img, dense, atol=1e-4)

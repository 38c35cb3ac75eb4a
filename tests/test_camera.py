"""Camera math tests (reference main.cpp:207-222, initMarcher ray setup)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cudaneuralrender.ops import camera as cam


def test_default_camera_matrices():
    c = cam.Camera()  # rx=ry=0, T=(0,0,-2)
    c2w, w2c = cam.view_matrices(c)
    c2w = np.asarray(c2w)
    # identity rotation, eye at +2z (translate by -T)
    np.testing.assert_allclose(c2w[:, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(c2w[:, 3], [0, 0, 2], atol=1e-6)
    # inverse maps the eye back to the origin
    eye_h = np.append(c2w[:, 3], 1.0)
    np.testing.assert_allclose((np.asarray(w2c) @ eye_h)[:3], [0, 0, 0], atol=1e-6)


def test_inverse_property_random_angles():
    c = cam.Camera(rotation_x=33.0, rotation_y=-71.0, translation=(0.1, -0.2, -3.0))
    c2w, w2c = cam.view_matrices(c)
    m = np.eye(4, dtype=np.float32)
    m[:3] = np.asarray(c2w)
    np.testing.assert_allclose(np.asarray(w2c) @ m, np.eye(4), atol=5e-4)


def test_rotation_composition_order():
    """M = Rx(-rx) @ Ry(-ry) (Eigen AngleAxis product, main.cpp:211-212)."""
    rx, ry = 30.0, 45.0
    c2w, _ = cam.view_matrices(cam.Camera(rotation_x=rx, rotation_y=ry))
    ax, ay = np.deg2rad(-rx), np.deg2rad(-ry)
    rx_m = np.array(
        [[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]]
    )
    ry_m = np.array(
        [[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]]
    )
    np.testing.assert_allclose(np.asarray(c2w)[:, :3], rx_m @ ry_m, atol=1e-6)


def test_generate_rays_shapes_and_norms():
    c2w, _ = cam.view_matrices(cam.Camera())
    origin, dirs = cam.generate_rays(c2w, 16, 32)
    assert origin.shape == (3,)
    assert dirs.shape == (16 * 32, 3)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(dirs), axis=-1), 1.0, atol=1e-6
    )


def test_ray_ndc_mapping():
    """Pixel (x, y) -> u = x/W*2-1, v = y/H*2-1, dir ~ [u, v, -2]
    (volumeRender_kernel.cu:315-321); flat index y*W+x."""
    h = w = 8
    c2w, _ = cam.view_matrices(cam.Camera())
    _, dirs = cam.generate_rays(c2w, h, w, focal=2.0)
    x, y = 3, 5
    u, v = x / w * 2 - 1, y / h * 2 - 1
    want = np.array([u, v, -2.0])
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(np.asarray(dirs[y * w + x]), want, atol=1e-6)


def test_center_ray_looks_at_origin():
    """Any pure orbit rotation keeps the center ray pointing at the origin."""
    for ry in (0.0, 90.0, 123.0):
        c = cam.Camera(rotation_y=ry)
        c2w, _ = cam.view_matrices(c)
        origin, dirs = cam.generate_rays(c2w, 3, 3)
        center = np.asarray(dirs[1 * 3 + 1 + 1])  # u=v=~ +1/3 off-center in 3x3
        # use exact center via odd trick: compute dir for u=v=0 manually
        r = np.asarray(c2w)[:, :3]
        d = r @ (np.array([0, 0, -2.0]) / 2.0)
        o = np.asarray(origin)
        # origin + t*d passes through 0 for t = |o|
        np.testing.assert_allclose(o + np.linalg.norm(o) * d, 0.0, atol=1e-5)


def test_from_cli_zoom():
    c = cam.Camera.from_cli(rx=10, ry=20, zoom=3.0)
    np.testing.assert_allclose(np.asarray(jnp.asarray(c.translation)), [0, 0, -3.0])

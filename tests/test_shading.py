"""Normal-estimation and shading tests (reference volumeRender_kernel.cu:361-413)."""
import numpy as np
import jax.numpy as jnp
import pytest

from cudaneuralrender.ops import sdf, shading


def test_autodiff_normals_on_sphere():
    f = lambda p: sdf.sphere(p, 1.0)
    pts = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]])
    n = np.asarray(shading.autodiff_normals(f, pts))
    np.testing.assert_allclose(n, np.asarray(pts), atol=1e-6)


def test_tetrahedron_close_to_autodiff():
    """FD tetrahedron normals (reference 4-tap trick) must approximate the
    exact autodiff gradient — the reverse of the reference's situation, where
    FD is the only option."""
    f = lambda p: sdf.box(p, (0.5, 0.4, 0.3))
    pts = jnp.array([[0.7, 0.0, 0.0], [0.0, 0.0, 0.5], [0.6, 0.5, 0.0]])
    fd = np.asarray(shading.tetrahedron_normals(f, pts, eps=1e-4))
    ad = np.asarray(shading.autodiff_normals(f, pts))
    np.testing.assert_allclose(fd, ad, atol=1e-3)


def test_tetrahedron_matches_reference_formula():
    """Check against a literal transcription of surfaceNormal (:362-377)."""
    f = lambda p: sdf.sphere(p, 0.9)
    p0 = np.array([0.9, 0.0, 0.0], np.float32)
    eps = 1e-5
    acc = np.zeros(3)
    for v in shading.TETRAHEDRON_VERTS:
        d = float(f(jnp.asarray((p0 + v * eps)[None, :]))[0])
        acc += v * d
    want = acc / np.linalg.norm(acc)
    got = np.asarray(shading.tetrahedron_normals(f, jnp.asarray(p0[None, :]), eps))[0]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_facing_color():
    n = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    c = np.asarray(shading.facing_color(n, d))
    np.testing.assert_allclose(c[0], [1, 1, 1, 1], atol=1e-6)  # facing
    np.testing.assert_allclose(c[1], [0, 0, 0, 1], atol=1e-6)  # back-facing clamps to 0
    np.testing.assert_allclose(c[2], [0, 0, 0, 1], atol=1e-6)  # perpendicular


def test_matcap_lookup_corners():
    """Normal (+1,+1) in eye space must sample texel (W-1, H-1); (-1,-1) texel (0,0).
    Truncation indexing parity with :398-399."""
    hm, wm = 4, 8
    tex = jnp.arange(hm * wm, dtype=jnp.float32).reshape(hm, wm, 1)
    tex = jnp.broadcast_to(tex, (hm, wm, 3)) / (hm * wm)
    eye = jnp.eye(4)  # identity normal matrix
    sq2 = 1.0 / np.sqrt(2.0)
    normals = jnp.array([[sq2, sq2, 0.0], [-sq2, -sq2, 0.0]])
    c = np.asarray(shading.matcap_color(normals, eye, tex))
    # n=(sq2, sq2): u=(sq2*0.5+0.5)*(W-1) -> int(5.97)=5 ... compute expected
    ux = int((sq2 * 0.5 + 0.5) * (wm - 1))
    uy = int((sq2 * 0.5 + 0.5) * (hm - 1))
    want = float(tex[uy, ux, 0])
    np.testing.assert_allclose(c[0, 0], want, atol=1e-6)
    ux2 = int((-sq2 * 0.5 + 0.5) * (wm - 1))
    uy2 = int((-sq2 * 0.5 + 0.5) * (hm - 1))
    np.testing.assert_allclose(c[1, :3], np.asarray(tex[uy2, ux2]), atol=1e-6)
    assert c.shape == (2, 4)
    np.testing.assert_allclose(c[:, 3], 1.0)  # alpha filled for rgb textures


def test_matcap_uses_normal_matrix():
    """A 180° y-rotation world->cam flips the x lookup."""
    hm = wm = 8
    tex = jnp.zeros((hm, wm, 3)).at[:, -1, :].set(1.0)  # right column white
    rot = jnp.asarray(
        np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    )  # 180° about y
    n = jnp.array([[1.0, 0.0, 0.0]])
    c_id = np.asarray(shading.matcap_color(n, jnp.eye(4), tex))
    c_rot = np.asarray(shading.matcap_color(n, rot, tex))
    np.testing.assert_allclose(c_id[0, :3], 1.0)
    np.testing.assert_allclose(c_rot[0, :3], 0.0)


def test_shade_dispatch():
    f = lambda p: sdf.sphere(p, 1.0)
    pts = jnp.array([[1.0, 0.0, 0.0]])
    dirs = jnp.array([[-1.0, 0.0, 0.0]])
    c = shading.shade(f, pts, dirs, mode="facing", normal_mode="autodiff")
    np.testing.assert_allclose(np.asarray(c)[0], [1, 1, 1, 1], atol=1e-5)
    c2 = shading.shade(f, pts, dirs, mode="facing", normal_mode="tetrahedron")
    np.testing.assert_allclose(np.asarray(c2)[0], [1, 1, 1, 1], atol=1e-3)
    with pytest.raises(ValueError):
        shading.shade(f, pts, dirs, mode="matcap")
    with pytest.raises(ValueError):
        shading.shade(f, pts, dirs, mode="bogus")

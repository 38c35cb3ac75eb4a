"""Multi-geometry batched rendering tests (BASELINE config 3)."""
import os

import numpy as np
import jax
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.render import multigeom

GEOM_DIR = "/root/reference/neuralGeometries"


@pytest.fixture(scope="module")
def all_geometries():
    if not os.path.isdir(GEOM_DIR):
        pytest.skip("reference geometries unavailable")
    paths = sorted(
        os.path.join(GEOM_DIR, f) for f in os.listdir(GEOM_DIR) if f.endswith(".h5")
    )
    return [cnr.load(p) for p in paths]


CFG = cnr.RenderConfig(width=32, height=32, scene="neural_raw", max_steps=200)


def test_stack_and_unstack(all_geometries):
    stacked = multigeom.stack_params(all_geometries)
    assert stacked[0].w.shape == (len(all_geometries), 3, 32)
    one = multigeom.unstack_params(stacked, 1)
    np.testing.assert_array_equal(np.asarray(one[0].w), np.asarray(all_geometries[1][0].w))


def test_render_batch_matches_individual(all_geometries):
    stacked = multigeom.stack_params(all_geometries[:3])
    batch = np.asarray(multigeom.render_batch(stacked, cnr.Camera(), CFG))
    assert batch.shape == (3, 32, 32, 4)
    for i in range(3):
        single = np.asarray(cnr.render_image(all_geometries[i], cnr.Camera(), CFG))
        np.testing.assert_allclose(batch[i], single, atol=1e-5)


def test_render_batch_cameras(all_geometries):
    stacked = multigeom.stack_params(all_geometries[:2])
    cams = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), cnr.Camera(rotation_y=0.0), cnr.Camera(rotation_y=90.0)
    )
    batch = np.asarray(multigeom.render_batch_cameras(stacked, cams, CFG))
    assert batch.shape == (2, 32, 32, 4)
    # geometry 0 at ry=0 must match the plain render
    single = np.asarray(cnr.render_image(all_geometries[0], cnr.Camera(), CFG))
    np.testing.assert_allclose(batch[0], single, atol=1e-5)


def test_mismatched_architectures_rejected(all_geometries):
    import jax.numpy as jnp
    from cudaneuralrender.models import mlp as mlp_lib

    other = mlp_lib.init_mlp(jax.random.key(0), sizes=(3, 8, 1))
    with pytest.raises(ValueError, match="mismatched"):
        multigeom.stack_params([all_geometries[0], other])


def test_contact_sheet(all_geometries):
    stacked = multigeom.stack_params(all_geometries[:3])
    batch = multigeom.render_batch(stacked, cnr.Camera(), CFG)
    sheet = np.asarray(multigeom.contact_sheet(batch, cols=2))
    assert sheet.shape == (64, 64, 4)


def test_render_batch_staged_expert_parallel(plane1_params):
    """EP mode: geometries committed round-robin across the 8-device mesh
    must produce the same frames as the single-device pipelined mode (jit
    runs each staged program where its params live)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs multiple virtual devices")
    from cudaneuralrender.models import mlp as mlp_lib
    from cudaneuralrender.render import multigeom

    geoms = [plane1_params] + [
        mlp_lib.init_mlp(jax.random.key(i)) for i in (1, 2)
    ]
    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=20.0)
    base = multigeom.render_batch_staged(geoms, cam, cfg)
    ep = multigeom.render_batch_staged(
        geoms, cam, cfg, devices=jax.devices()[:4])
    for a, b in zip(base, ep):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

"""Fault-tolerant tile-retry rendering (parallel/fault.py): band assembly
matches the monolithic render, injected faults are retried exactly, and
exhausted retries raise."""
import numpy as np
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.parallel import fault


def _cfg():
    return cnr.RenderConfig(width=16, height=16, scene="sphere", max_steps=64)


def test_tiled_matches_monolithic():
    cfg = _cfg()
    cam = cnr.Camera(rotation_y=30.0)
    whole = np.asarray(cnr.render_image(None, cam, cfg))
    tiled = fault.render_tiled(None, cam, cfg, n_bands=4)
    np.testing.assert_allclose(tiled, whole, atol=1e-6)


def test_injected_fault_is_retried():
    cfg = _cfg()
    inj = fault.FaultInjector(fail_times=2)
    tiled = fault.render_tiled(None, cnr.Camera(), cfg, n_bands=4, injector=inj)
    whole = np.asarray(cnr.render_image(None, cnr.Camera(), cfg))
    assert inj.injected == 2
    np.testing.assert_allclose(tiled, whole, atol=1e-6)


def test_retries_exhausted_raises():
    cfg = _cfg()
    inj = fault.FaultInjector(fail_times=100)
    with pytest.raises(RuntimeError, match="failed .* times"):
        fault.render_tiled(None, cnr.Camera(), cfg, n_bands=2, max_retries=2,
                           injector=inj)


def test_neural_bands(plane1_params):
    cfg = cnr.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=128)
    cam = cnr.Camera(rotation_y=45.0)
    whole = np.asarray(cnr.render_image(plane1_params, cam, cfg))
    tiled = fault.render_tiled(plane1_params, cam, cfg, n_bands=2)
    np.testing.assert_allclose(tiled, whole, atol=1e-6)


def test_render_tiled_staged_band_path(plane1_params):
    """Band rendering through the STAGED fast path (fault.render_band_auto):
    bands assembled must equal the single-program staged render exactly
    (per-lane march math is bucket-layout-independent)."""
    import cudaneuralrender as cnr
    from cudaneuralrender.parallel import fault

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=25.0, rotation_x=10.0)
    tiled = fault.render_tiled(plane1_params, cam, cfg, n_bands=4)
    whole = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    np.testing.assert_array_equal(tiled, whole)


def test_render_tiled_staged_with_faults(plane1_params):
    """Injected faults retry staged bands exactly like dense ones."""
    import cudaneuralrender as cnr
    from cudaneuralrender.parallel import fault

    cfg = cnr.RenderConfig(width=32, height=32, scene="neural_raw",
                           max_steps=200, march_impl="staged",
                           coarse_pallas=False, refine_pallas=False)
    cam = cnr.Camera(rotation_y=25.0)
    inj = fault.FaultInjector(fail_times=2)
    tiled = fault.render_tiled(plane1_params, cam, cfg, n_bands=4,
                               max_retries=3, injector=inj)
    whole = np.asarray(cnr.render_staged(plane1_params, cam, cfg))
    assert inj.injected == 2
    np.testing.assert_array_equal(tiled, whole)

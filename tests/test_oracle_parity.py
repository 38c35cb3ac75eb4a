"""Per-pixel parity against the NumPy reference oracle (BASELINE configs 1-2).

tests/reference_oracle.py is an independent float32 port of the CUDA
reference's full algorithm (march ordering, tetrahedron normals, matcap
texel rounding, rgbaFloatToInt — see its docstring for the file:line map).
These tests make "parity" mean real per-pixel allclose, replacing the
silhouette-IoU bar of benchmarks/golden_parity.py as the correctness anchor.

Documented tolerances (measured headroom ~2x on CPU):
  * hit masks: EXACTLY equal. The framework's march_precision="full" path
    reproduces the reference's per-ray decision sequence; the only residual
    difference is f32 matmul accumulation order in the MLP (XLA dot vs
    NumPy), which has never flipped a hit at these resolutions.
  * facing colors on hit pixels: atol 1e-2 (measured max 5.2e-3). The
    tetrahedron normal divides by NORMAL_EPSILON=1e-5-scale differences, so
    MLP accumulation noise (~5e-7) amplifies into the 1e-3 color range.
  * matcap colors: nearest-neighbor texel lookup quantizes the normal, so
    ulp-level normal differences flip to an ADJACENT texel. On a smooth
    matcap (Blue Metal: max adjacent-texel step 0.059) that bounds the
    error to atol 0.08; on high-frequency matcaps (Chrome) the flipped
    sliver is bounded as a fraction instead.
"""
import numpy as np
import pytest

import cudaneuralrender as cnr
from cudaneuralrender.utils import image_io

import reference_oracle as oracle

# max_steps=600 keeps the oracle fast; the staged path's dense fallback
# guarantees exact truncation semantics (renderer.render_staged).
STEPS = 600


def _full_cfg(res: int, **kw) -> "cnr.RenderConfig":
    return cnr.RenderConfig(
        width=res, height=res, max_steps=STEPS,
        normal_mode="tetrahedron", march_impl="staged",
        march_precision="full", rgba_packed=False, **kw,
    )


def _render_both(params, res, rx, ry, scene="neural_raw", shading="facing",
                 matcap=None, frame=0.0, num_inputs=3):
    cfg = _full_cfg(res, scene=scene, shading=shading, num_inputs=num_inputs)
    cam = cnr.Camera(rotation_x=rx, rotation_y=ry)
    mine = np.asarray(cnr.render_staged(
        params, cam, cfg,
        matcap=None if matcap is None else np.asarray(matcap), frame=frame,
    ))
    ref = oracle.render(
        params, res, res, rotation_x=rx, rotation_y=ry, scene=scene,
        shading=shading, matcap=matcap, frame=frame, num_inputs=num_inputs,
        max_steps=STEPS,
    )
    return mine, ref


@pytest.mark.parametrize("rx,ry", [(0.0, 0.0), (10.0, 40.0), (-25.0, 160.0)])
def test_plane1_facing_allclose(plane1_params, rx, ry):
    """BASELINE config 1: plane_1 facing-shaded render == oracle, 3 cameras."""
    mine, ref = _render_both(plane1_params, 128, rx, ry)
    np.testing.assert_array_equal(mine[..., 3] > 0, ref[..., 3] > 0)
    hit = ref[..., 3] > 0
    np.testing.assert_allclose(mine[hit], ref[hit], atol=1e-2)
    assert hit.any()
    np.testing.assert_array_equal(mine[~hit], 0.0)


@pytest.fixture(scope="module")
def car1_params(car1_path):
    from cudaneuralrender.models import checkpoint

    return checkpoint.load_keras_h5(car1_path)


def test_car1_matcap_allclose_smooth(car1_params):
    """BASELINE config 2: car_1 512²-class matcap parity (at 256² for CI
    speed; the math is resolution-independent). Smooth matcap bounds the
    nearest-texel quantization."""
    mc = image_io.load_matcap("/root/reference/matcaps/Blue Metal.png")
    mine, ref = _render_both(car1_params, 256, 10.0, 40.0,
                             shading="matcap", matcap=mc)
    np.testing.assert_array_equal(mine[..., 3] > 0, ref[..., 3] > 0)
    hit = ref[..., 3] > 0
    assert hit.mean() > 0.1
    np.testing.assert_allclose(mine[hit], ref[hit], atol=0.08)


def test_car1_matcap_chrome_structural(car1_params, matcap_path):
    """High-frequency matcap: texel flips allowed on a bounded sliver."""
    mc = image_io.load_matcap(matcap_path)
    mine, ref = _render_both(car1_params, 256, 10.0, 40.0,
                             shading="matcap", matcap=mc)
    np.testing.assert_array_equal(mine[..., 3] > 0, ref[..., 3] > 0)
    hit = ref[..., 3] > 0
    err = np.abs(mine - ref).max(axis=-1)
    flipped = (err > 2e-2) & hit
    assert flipped.sum() / hit.sum() < 0.10, f"texel flips {flipped.sum()}/{hit.sum()}"
    np.testing.assert_allclose(mine[hit & ~flipped], ref[hit & ~flipped], atol=2e-2)


def test_many_sphere_csg_allclose(plane1_params):
    """Animated CSG composition marches identically (frame=77)."""
    mine, ref = _render_both(plane1_params, 128, 5.0, 77.0,
                             scene="many_sphere", frame=77.0)
    np.testing.assert_array_equal(mine[..., 3] > 0, ref[..., 3] > 0)
    hit = ref[..., 3] > 0
    assert hit.mean() > 0.05
    np.testing.assert_allclose(mine[hit], ref[hit], atol=1e-2)


def test_animation_inputs_allclose(rng):
    """num_inputs=4 appends the frame to every MLP input (createBatch,
    volumeRender_kernel.cu:533-544). The shipped checkpoints are all
    3-input, so the 4-input path is checked at SDF-value level with a
    synthetic 4-input MLP."""
    import jax
    import jax.numpy as jnp

    from cudaneuralrender.models import mlp
    from cudaneuralrender.render.renderer import scene_fn

    params = mlp.init_mlp(jax.random.key(7), sizes=(4, 16, 16, 1))
    pts = rng.uniform(-1.0, 1.0, (2048, 3)).astype(np.float32)
    cfg = cnr.RenderConfig(scene="neural_raw", num_inputs=4)
    got = np.asarray(scene_fn(params, cfg, 123.0)(jnp.asarray(pts)))
    want = oracle.make_scene_eval("neural_raw", params, 123.0, num_inputs=4)(pts)
    # rtol: the raw frame value (123) inflates activations, so f32
    # accumulation-order noise scales with magnitude.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rgba_pack_bit_parity(rng):
    """pack_rgba_u32 == the oracle's rgbaFloatToInt, bit for bit."""
    import jax.numpy as jnp

    from cudaneuralrender.ops import shading

    colors = rng.uniform(-0.2, 1.2, (4096, 4)).astype(np.float32)
    got = np.asarray(shading.pack_rgba_u32(jnp.asarray(colors)))
    want = oracle.rgba_float_to_int(colors)
    np.testing.assert_array_equal(got, want)


def test_oracle_matches_dense_path_exactly(plane1_params):
    """The dense while-loop path (render_image) is the semantics yardstick:
    zero hit-mask difference vs the oracle across the budget-truncation
    regime (max_steps=600 leaves stragglers unresolved)."""
    cfg = _full_cfg(128)
    cam = cnr.Camera(rotation_x=0.0, rotation_y=0.0)
    mine = np.asarray(cnr.render_image(plane1_params, cam, cfg))
    ref = oracle.render(plane1_params, 128, 128, max_steps=STEPS)
    np.testing.assert_array_equal(mine[..., 3] > 0, ref[..., 3] > 0)

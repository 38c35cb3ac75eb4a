"""Image I/O tests (reference src/neuralUtils/image.cu semantics)."""
import numpy as np

from cudaneuralrender.utils import image_io


def test_to_uint8_flips_vertically():
    rgba = np.zeros((2, 3, 4), np.float32)
    rgba[0, 0] = [1, 0, 0, 1]  # bottom-left in render space
    img = image_io.to_uint8_image(rgba)
    # ends up at top... renderer row 0 = bottom, flipped -> last row of output
    assert tuple(img[1, 0]) == (255, 0, 0, 255)
    assert img[0, 0].sum() == 0


def test_parity_flip_mirrors():
    """parity_flip reproduces the reference's 180° rotation (savePNG byte
    reverse, image.cu:84-98)."""
    rgba = np.zeros((2, 3, 4), np.float32)
    rgba[0, 0] = [1, 1, 1, 1]
    img = image_io.to_uint8_image(rgba, parity_flip=True)
    assert tuple(img[1, 2]) == (255, 255, 255, 255)


def test_saturation():
    rgba = np.array([[[2.0, -1.0, 0.5, 1.0]]], np.float32)
    img = image_io.to_uint8_image(rgba)
    assert tuple(img[0, 0]) == (255, 0, 127, 255)


def test_pack_unpack_roundtrip(rng):
    u8 = rng.integers(0, 256, size=(4, 5, 4), dtype=np.uint8)
    packed = image_io.pack_rgba_uint32(u8)
    np.testing.assert_array_equal(image_io.unpack_rgba_uint32(packed), u8)
    # packing format parity: a<<24|b<<16|g<<8|r (volumeRender_kernel.cu:273)
    one = image_io.pack_rgba_uint32(np.array([[[1, 2, 3, 4]]], np.uint8))
    assert int(one[0, 0]) == (4 << 24) | (3 << 16) | (2 << 8) | 1


def test_png_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(16, 24, 4), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    image_io.save_png(p, img)
    np.testing.assert_array_equal(image_io.load_png(p), img)


def test_ppm_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(8, 12, 3), dtype=np.uint8)
    p = str(tmp_path / "t.ppm")
    image_io.save_ppm(p, img)
    np.testing.assert_array_equal(image_io.load_ppm(p), img)


def test_load_reference_golden_ppm():
    import os, pytest

    path = "/root/reference/neuralGeometries/plane_1.h5.ppm"
    if not os.path.exists(path):
        pytest.skip("reference goldens unavailable")
    img = image_io.load_ppm(path)
    assert img.shape == (1024, 1024, 3)
    assert img.max() > 0


def test_load_matcap():
    import os, pytest

    path = "/root/reference/matcaps/Chrome.png"
    if not os.path.exists(path):
        pytest.skip("reference matcaps unavailable")
    tex = image_io.load_matcap(path)
    assert tex.ndim == 3 and tex.shape[-1] == 4
    assert tex.dtype == np.float32
    assert 0.0 <= tex.min() and tex.max() <= 1.0

"""The port's picture export (export/image.py, native/src/export.cc built
as the library mvt_export) against the JAX package's, on the same
seeded planes, with tolerance 0: every native binding gives the JAX
binding's bytes (JPEG at several qualities and odd sizes, PNG with one
band and with one band per hardware thread, BMP, TGA, the RGB
conversion); every `_py` writer gives the JAX one's bytes;
export_picture writes the same file for every PictureFormat;
MINIVIDEO_TPU_NO_NATIVE=1 selects the Python writers in both packages;
and a failed build of export.cc raises.  (The port is imported inside
the tests: see torch_port_helpers.py.)"""

import numpy as np
import pytest

from minivideo_tpu import native as jax_native
from minivideo_tpu import settings as jax_settings
from minivideo_tpu.codecs import PictureFormat as JaxFormat
from minivideo_tpu.export import image as JIMG


def _planes(h, w, seed):
    """Seeded 4:2:0 planes: a gradient with noise (like a picture) and
    chroma of ceil(h/2) x ceil(w/2), as a decode of odd size has."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((yy * 1.3 + xx * 0.7) % 220 + rng.integers(0, 36, (h, w)))
    ch, cw = (h + 1) // 2, (w + 1) // 2
    cb = rng.integers(0, 256, (ch, cw))
    cr = 128 + (np.mgrid[0:ch, 0:cw][0] % 64)
    return tuple(np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))


@pytest.mark.parametrize("quality,h,w", [(10, 48, 64), (75, 17, 30),
                                         (95, 37, 53)])
def test_jpeg_native_is_the_jax_binding_s(quality, h, w):
    from minivideo_tpu_torch import native
    planes = _planes(h, w, seed=quality + h)
    got = native.encode_jpeg_native(*planes, quality)
    assert got == jax_native.encode_jpeg_native(*planes, quality)
    assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"


@pytest.mark.parametrize("threads", [1, 0])
def test_png_native_is_the_jax_binding_s(threads):
    """threads=0 is one band per hardware thread: the bytes depend on
    the host's thread count, so they are compared on one host only."""
    from minivideo_tpu_torch import native
    rgb = np.random.default_rng(3).integers(0, 256, (67, 45, 3), np.uint8)
    for level in (1, 3, 9):
        assert native.encode_png_native(rgb, level, threads) == \
            jax_native.encode_png_native(rgb, level, threads)


def test_bmp_tga_rgb_native_are_the_jax_bindings_s():
    from minivideo_tpu_torch import native
    for h, w in ((48, 64), (37, 53)):
        planes = _planes(h, w, seed=w)
        rgb = native.yuv420_to_rgb_native(*planes)
        np.testing.assert_array_equal(
            rgb, jax_native.yuv420_to_rgb_native(*planes))
        assert native.encode_bmp_native(rgb) == \
            jax_native.encode_bmp_native(rgb)
        assert native.encode_tga_native(rgb) == \
            jax_native.encode_tga_native(rgb)


@pytest.mark.parametrize("name", ["bmp", "tga", "png", "jpeg"])
def test_py_writers_are_the_jax_package_s(name, tmp_path):
    from minivideo_tpu_torch.export import image as IMG
    planes = _planes(37, 53, seed=5)
    rgb = IMG.yuv420_to_rgb_py(*planes)
    np.testing.assert_array_equal(rgb, JIMG.yuv420_to_rgb_py(*planes))
    got, want = tmp_path / "port", tmp_path / "jax"
    if name == "jpeg":
        for quality in (10, 90):
            IMG.write_jpeg_py(str(got), *planes, quality)
            JIMG.write_jpeg_py(str(want), *planes, quality)
            assert got.read_bytes() == want.read_bytes(), quality
        return
    getattr(IMG, f"write_{name}_py")(str(got), rgb)
    getattr(JIMG, f"write_{name}_py")(str(want), rgb)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("fmt", ["JPG", "PNG", "BMP", "TGA", "YUV420",
                                 "YUV444"])
def test_export_picture_is_the_jax_package_s(fmt, tmp_path):
    """Every format, with the RGB converted here and given by the caller
    (as a decode with want_rgb hands it over)."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.export import image as IMG
    planes = _planes(48, 80, seed=11)
    rgb = JIMG.yuv420_to_rgb(*planes)
    for tag, given in (("conv", None), ("given", rgb)):
        got = IMG.export_picture(str(tmp_path / f"p_{tag}"),
                                 PictureFormat[fmt], *planes, 60, rgb=given)
        want = JIMG.export_picture(str(tmp_path / f"j_{tag}"),
                                   JaxFormat[fmt], *planes, 60, rgb=given)
        assert got.rsplit(".", 1)[1] == want.rsplit(".", 1)[1]
        assert open(got, "rb").read() == open(want, "rb").read(), tag


def test_no_native_selects_the_python_writers(tmp_path, monkeypatch):
    """MINIVIDEO_TPU_NO_NATIVE=1: both packages write with the `_py`
    writers (the JAX package reads its settings snapshot once, so the
    snapshot is dropped here and restored by monkeypatch)."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.export import image as IMG
    monkeypatch.setenv("MINIVIDEO_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jax_settings, "_settings", None)
    assert IMG._native() is None and JIMG._native() is None
    planes = _planes(32, 48, seed=2)
    rgb = IMG.yuv420_to_rgb(*planes)
    np.testing.assert_array_equal(rgb, IMG.yuv420_to_rgb_py(*planes))
    for fmt in ("JPG", "PNG", "BMP", "TGA"):
        got = IMG.export_picture(str(tmp_path / "p"), PictureFormat[fmt],
                                 *planes, 75)
        want = JIMG.export_picture(str(tmp_path / "j"), JaxFormat[fmt],
                                   *planes, 75)
        oracle = tmp_path / f"oracle.{fmt}"
        if fmt == "JPG":
            IMG.write_jpeg_py(str(oracle), *planes, 75)
        else:
            getattr(IMG, f"write_{fmt.lower()}_py")(str(oracle), rgb)
        data = open(got, "rb").read()
        assert data == open(want, "rb").read() == oracle.read_bytes(), fmt
        if fmt == "PNG":      # differs from the native PNG: not native
            assert data[-60:] != jax_native.encode_png_native(rgb)[-60:]


def test_failed_export_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: building mvt_export raises, and
    so do the writers; nothing falls back to Python."""
    from minivideo_tpu_torch import _build, native
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.export import image as IMG
    bad = tmp_path / "src" / "export.cc"
    bad.parent.mkdir()
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("MINIVIDEO_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_EXPORT_SRC", str(bad))
    monkeypatch.setattr(native, "_export_lib", None)
    with pytest.raises(RuntimeError, match="building mvt_export failed"):
        native.build_export()
    planes = _planes(16, 16, seed=1)
    for fmt in (PictureFormat.JPG, PictureFormat.PNG):
        with pytest.raises(RuntimeError, match="mvt_export"):
            IMG.export_picture(str(tmp_path / "x"), fmt, *planes)
    assert not (tmp_path / "x.jpg").exists()

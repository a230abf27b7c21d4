"""The port's file entry point and RGB output against the JAX package's,
on the CPU: mv_open / mv_parse / mv_decode(device="cpu") from MP4,
Matroska, MPEG-TS, AVI, MPEG-PS and raw ES files equal the JAX package's
mv_decode(engine="np") (the stream handed to the decoder, the planes and
the crop); want_rgb
equals the JAX package's device RGB (ops/color.py) at even and odd
crops; yuv420_to_rgb_device equals the JAX function with tolerance 0;
mv_get_infos has the JAX package's keys; without a card mv_decode
raises.  (torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from torch_port_helpers import assert_planes_equal

WRITERS = {
    "mp4": lambda s: C.write_mp4(s, 80, 48),
    "mkv": lambda s: C.write_mkv(s, 80, 48),
    "ts": C.write_ts,
    "avi": lambda s: C.write_avi(s, 80, 48),
    "mpg": C.write_ps,
    "264": lambda s: s,
}


def _cavlc():
    # cropped to 76x42: the crop reaches the display size
    return make_stream(width_mbs=5, height_mbs=3, n_pictures=3, seed=31,
                       profile=100, transform_8x8=True,
                       mb_kinds=("i16", "i4", "i8"), crop=(1, 1, 0, 3))


def _write(tmp_path, fmt, data):
    path = tmp_path / f"clip.{fmt}"
    path.write_bytes(WRITERS[fmt](data))
    return str(path)


class _Spy:
    """Records the stream a package's mv_decode hands to decode_annexb."""

    def __init__(self, monkeypatch, module):
        self.data = None
        real = module.decode_annexb

        def spy(data, *a, **k):
            self.data = data
            return real(data, *a, **k)
        monkeypatch.setattr(module, "decode_annexb", spy)


def _both(path, n, **port_kw):
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    got, want = api.mv_open(path), jax_api.mv_open(path)
    assert api.mv_parse(got, audio=False, subs=False)
    assert jax_api.mv_parse(want, audio=False, subs=False)
    pics = api.mv_decode(got, picture_number=n, device="cpu", **port_kw)
    ref = jax_api.mv_decode(want, picture_number=n, engine="np")
    api.mv_close(got)
    jax_api.mv_close(want)
    return pics, ref


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_mv_decode_equals_jax(fmt, tmp_path, monkeypatch):
    from minivideo_tpu.models.h264 import decoder as jax_decoder
    from minivideo_tpu_torch.models.h264 import decoder
    path = _write(tmp_path, fmt, _cavlc())
    port_spy = _Spy(monkeypatch, decoder)
    jax_spy = _Spy(monkeypatch, jax_decoder)
    got, want = _both(path, 3)
    assert port_spy.data == jax_spy.data and port_spy.data
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.width, g.height) == (w.width, w.height) == (76, 42)
        assert g.idr_index == w.idr_index
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr),
                            f"{fmt} pic {i}")
        assert_planes_equal(w.cropped(), g.cropped(), f"{fmt} crop {i}")
        assert g.rgb is None


def test_mv_decode_cabac_selects_pictures(tmp_path):
    """A CABAC MP4, two pictures of four asked for, in the three IDR
    selection modes."""
    from minivideo_tpu.codecs import PictureRepartition as JaxRep
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    from minivideo_tpu_torch.codecs import PictureRepartition
    data = make_stream2(width_mbs=4, height_mbs=3, n_pictures=4, seed=32,
                        entropy="cabac", mb_kinds=("i16", "i4", "i8"),
                        transform_8x8=True, allow_pcm=True)
    path = _write(tmp_path, "mp4", data)
    for mode in ("UNFILTERED", "ORDERED", "DISTRIBUTED"):
        got, want = api.mv_open(path), jax_api.mv_open(path)
        assert api.mv_parse(got) and jax_api.mv_parse(want)
        g = api.mv_decode(got, 2, PictureRepartition[mode], device="cpu")
        w = jax_api.mv_decode(want, 2, JaxRep[mode], engine="np")
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            assert_planes_equal((b.y, b.cb, b.cr), (a.y, a.cb, a.cr), mode)
        api.mv_close(got)
        jax_api.mv_close(want)


def _jax_rgb_pictures(data):
    """The JAX package's pictures with their device RGB: engine "jax" is
    its XLA wave engine on the CPU, converted by its ops/color.py."""
    from minivideo_tpu.models.h264.decoder import decode_annexb
    pics = decode_annexb(data, engine="jax", want_rgb=True)
    assert pics and all(p.rgb is not None for p in pics)
    return pics


@pytest.mark.parametrize("crop", ["even", "odd"])
def test_want_rgb_equals_jax_device_rgb(crop):
    """The port's RGB (converted on the decode's device, then cropped by
    cropped_rgb) equals the JAX package's device RGB.  The SPS can only
    crop by 2 in 4:2:0, so the odd display size is set on the pictures
    of both packages alike."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    data = _cavlc()
    want = _jax_rgb_pictures(data)
    got = decode_annexb(data, device="cpu", want_rgb=True)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.rgb.shape == (48, 80, 3) and g.rgb.dtype == np.uint8
        np.testing.assert_array_equal(g.rgb, w.rgb, err_msg=f"pic {i}")
        if crop == "odd":
            g.width, g.height = w.width, w.height = 75, 41
        np.testing.assert_array_equal(g.cropped_rgb(), w.cropped_rgb())
        assert g.cropped_rgb().shape == (g.height, g.width, 3)


def test_cropped_rgb_host_fallback_equals_device():
    """Without RGB from the decode, cropped_rgb converts the cropped
    planes on the host; at an even crop that equals the device path and
    the JAX package's host converter."""
    from minivideo_tpu.export.image import yuv420_to_rgb_py as jax_host
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    data = _cavlc()
    with_rgb = decode_annexb(data, device="cpu", want_rgb=True)
    without = decode_annexb(data, device="cpu")
    for a, b in zip(with_rgb, without):
        assert b.rgb is None
        host = b.cropped_rgb()
        np.testing.assert_array_equal(host, a.cropped_rgb())
        np.testing.assert_array_equal(host, jax_host(*b.cropped()))


def test_mv_decode_want_rgb_from_file(tmp_path):
    """want_rgb through mv_decode, from an MP4, against the JAX
    package's mv_decode(engine="jax", want_rgb=True); the H264Decoder
    NALU feed converts too."""
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    from minivideo_tpu_torch.models.h264.decoder import H264Decoder
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    data = _cavlc()
    path = _write(tmp_path, "mp4", data)
    got, want = api.mv_open(path), jax_api.mv_open(path)
    assert api.mv_parse(got) and jax_api.mv_parse(want)
    g = api.mv_decode(got, 3, device="cpu", want_rgb=True)
    w = jax_api.mv_decode(want, 3, engine="jax", want_rgb=True)
    api.mv_close(got)
    jax_api.mv_close(want)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.rgb, b.rgb)
    dec = H264Decoder(device="cpu", want_rgb=True)
    fed = [dec.feed_nalu(parse_nalu(raw, off))
           for off, raw in split_annexb(data)]
    fed = [p for p in fed if p is not None]
    assert len(fed) == 3
    for a, b in zip(fed, g):
        np.testing.assert_array_equal(a.rgb, b.rgb)


@pytest.mark.parametrize("shape", [(3, 32, 48), (2, 17, 23)])
def test_yuv420_to_rgb_device_equals_jax(shape):
    """Random planes over the whole u8 range (the products go negative
    and past 255), even and odd luma sizes: tolerance 0."""
    import torch
    from minivideo_tpu.ops.color import yuv420_to_rgb_device as jax_rgb
    from minivideo_tpu_torch.export.image import yuv420_to_rgb_py
    from minivideo_tpu_torch.ops.color import yuv420_to_rgb_device
    b, h, w = shape
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    cb = rng.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, cb.shape, dtype=np.uint8)
    got = yuv420_to_rgb_device(torch.from_numpy(y), torch.from_numpy(cb),
                               torch.from_numpy(cr))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, h, w, 3)
    want = np.asarray(jax_rgb(y, cb, cr))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(b):
        np.testing.assert_array_equal(
            yuv420_to_rgb_py(y[i], cb[i], cr[i]), want[i])


def test_infos_have_the_jax_package_keys():
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    got, want = api.mv_get_infos(), jax_api.mv_get_infos()
    assert set(got) == (set(want) - {"jax"}) | {"torch"}
    import torch
    assert got["torch"] == torch.__version__
    assert got["devices"] == [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())]
    assert got["engine"] == "fused"
    assert api.mv_endianness() == jax_api.mv_endianness()
    for k in ("version", "python", "endianness", "ipcm"):
        assert got[k] == want[k]


def test_mv_decode_without_a_card_raises(tmp_path):
    """device=None means the GPU: without one, mv_decode raises, also on
    a file with no video track; it never falls back to the CPU."""
    import torch
    from minivideo_tpu_torch import api
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for name, blob in (("clip.mp4", WRITERS["mp4"](_cavlc())),
                       ("tone.mp3", C.write_mp3(n_frames=8))):
        path = tmp_path / name
        path.write_bytes(blob)
        m = api.mv_open(str(path))
        assert api.mv_parse(m)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.mv_decode(m, picture_number=3)
        api.mv_close(m)

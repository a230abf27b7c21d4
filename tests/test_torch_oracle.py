"""The port's `np` and `wave` engines through its entry points against the
JAX package's engines of the same name, on the CPU, with tolerance 0:
the numpy oracle (transform_np.py, recon_np.reconstruct_frame),
decode_annexb (full streams, max_pictures, an odd crop, the three
BAD_STREAMS), H264Decoder.feed_nalu per engine, batch_thumbnail and the
thumbnailer app, the engine names and settings, and the native CABAC bin
counter.

The JAX wave loop compiles once per geometry and batch (seconds), so the
decode streams share one geometry (6x4 MBs) and batch (2 pictures).
(torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import functools
import os

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from torch_port_helpers import assert_planes_equal

KINDS = ("i16", "i4", "i8")
DECODE = {  # name -> (stream, max_pictures)
    "full": (lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=31, profile=100,
        transform_8x8=True, mb_kinds=KINDS, allow_pcm=True, n_slices=2),
        0),
    "max_pictures": (lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=3, seed=32, qp=40,
        mb_kinds=("i16", "i4"), allow_pcm=True), 2),
    "odd_crop": (lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=33, profile=100,
        transform_8x8=True, mb_kinds=KINDS, crop=(1, 2, 0, 3)), 0),
}


def _same_pictures(want, got, what):
    assert len(got) == len(want), what
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g.width, g.height, g.idr_index) == \
            (w.width, w.height, w.idr_index), f"{what} pic {i}"
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr),
                            f"{what} pic {i}")
        assert_planes_equal(w.cropped(), g.cropped(), f"{what} crop {i}")


# ---------------------------------------------------------------------------
# the numpy oracle


def test_transform_np_is_the_jax_modules():
    """Every function of transform_np on random inputs at every qp."""
    from minivideo_tpu.models.h264 import transform_np as J
    from minivideo_tpu_torch.models.h264 import transform_np as T
    rng = np.random.default_rng(1)
    zz4, zz8 = rng.integers(1, 256, 16), rng.integers(1, 256, 64)
    ls4, ls8 = J.level_scale_4x4(zz4), J.level_scale_8x8(zz8)
    np.testing.assert_array_equal(T.level_scale_4x4(zz4), ls4)
    np.testing.assert_array_equal(T.level_scale_8x8(zz8), ls8)
    for qp in range(52):
        c4 = rng.integers(-2048, 2048, (4, 4))
        c8 = rng.integers(-2048, 2048, (8, 8))
        c2 = rng.integers(-2048, 2048, (2, 2))
        for f, args in ((lambda m, *a: m.dequant_4x4(*a), (c4, qp, ls4)),
                        (lambda m, *a: m.dequant_4x4(*a, True),
                         (c4, qp, ls4)),
                        (lambda m, *a: m.dequant_8x8(*a), (c8, qp, ls8)),
                        (lambda m, *a: m.luma_dc_transform(*a),
                         (c4, qp, ls4)),
                        (lambda m, *a: m.chroma_dc_transform(*a),
                         (c2, qp, ls4)),
                        (lambda m, *a: m.idct_4x4(*a), (c4 * 16,)),
                        (lambda m, *a: m.idct_8x8(*a), (c8 * 16,))):
            np.testing.assert_array_equal(f(T, *args), f(J, *args))
    x = rng.integers(-300, 600, 50)
    np.testing.assert_array_equal(T.clip_pixel(x), J.clip_pixel(x))


@pytest.mark.parametrize("name", ["slices_pcm", "cabac_lists"])
def test_reconstruct_frame_matches_jax(name):
    """recon_np.reconstruct_frame of each package's own parse: I_PCM,
    8x8, three slices; CABAC; scaling lists."""
    from minivideo_tpu.models.h264.decoder import H264Decoder as JDec
    from minivideo_tpu.models.h264.decoder import group_idr_access_units \
        as j_groups
    from minivideo_tpu.models.h264.recon_np import reconstruct_frame as j_rf
    from minivideo_tpu_torch.models.h264.decoder import (
        H264Decoder, group_idr_access_units)
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    from minivideo_tpu_torch.models.h264.recon_np import reconstruct_frame
    if name == "slices_pcm":
        data = make_stream(width_mbs=5, height_mbs=4, n_pictures=2, seed=34,
                           profile=100, transform_8x8=True, mb_kinds=KINDS,
                           allow_pcm=True, n_slices=3, density=0.6)
    else:
        data = make_stream2(5, 4, 2, 35, entropy="cabac", mb_kinds=KINDS,
                            transform_8x8=True, allow_pcm=True)
    out = []
    for dec, groups, rf in ((H264Decoder(device="cpu"),
                             group_idr_access_units, reconstruct_frame),
                            (JDec(), j_groups, j_rf)):
        nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
        for n in nalus:
            if n.nal_unit_type in (7, 8):
                dec.feed_nalu(n)
        out.append([rf(*dec.parse_idr_syntax(g)) for g in groups(nalus)])
    assert len(out[0]) == len(out[1]) == 2
    for i, (got, want) in enumerate(zip(*out)):
        assert all(p.dtype == np.uint8 for p in got)
        assert_planes_equal(want, got, f"{name} pic {i}")


# ---------------------------------------------------------------------------
# decode_annexb per engine


@functools.lru_cache(maxsize=None)
def _jax_decode(name, engine):
    from minivideo_tpu.models.h264.decoder import decode_annexb
    stream, max_pictures = DECODE[name]
    return decode_annexb(stream(), max_pictures=max_pictures, engine=engine)


@pytest.mark.parametrize("engine", ["np", "wave"])
@pytest.mark.parametrize("name", list(DECODE))
def test_decode_annexb_matches_jax(name, engine):
    """decode_annexb(engine, device="cpu") gives the JAX package's
    pictures with the same engine: planes, crops, indices, and the
    max_pictures stop; with want_rgb, "np" leaves the RGB to the host
    and "wave" converts on the device."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    stream, max_pictures = DECODE[name]
    want = _jax_decode(name, engine)
    got = decode_annexb(stream(), max_pictures=max_pictures, engine=engine,
                        device="cpu", want_rgb=True)
    _same_pictures(want, got, f"{name} {engine}")
    assert len(got) == (max_pictures or 2)
    for p in got:
        assert (p.rgb is None) == (engine == "np")
        assert p.cropped_rgb().shape == (p.height, p.width, 3)


@pytest.mark.parametrize("name", ["truncated_idr", "joined_id0",
                                  "error_run"])
def test_bad_streams_np_and_wave(name):
    """Streams with bad pictures: "np" drops the JAX package's "np"
    pictures (errors counted per IDR picture, the max of 64 in a row),
    and "wave" returns the same pictures (the JAX package's engines agree
    on these streams: tests/test_torch_errors.py)."""
    from minivideo_tpu.models.h264.decoder import decode_annexb as j_decode
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.streams import bad_stream
    data = bad_stream(name, make_stream)
    want = j_decode(data, engine="np")
    assert want
    for engine in ("np", "wave"):
        _same_pictures(want, decode_annexb(data, engine=engine,
                                           device="cpu"),
                       f"{name} {engine}")


# ---------------------------------------------------------------------------
# names, settings and the NALU feed


def test_engine_names_and_settings():
    """resolve_engine takes the three engines and "jax" (the fused engine
    on every device) and refuses others; settings.ENGINES and get_infos;
    without a card every engine raises for device=None, with no fallback
    to the CPU."""
    import torch
    from minivideo_tpu_torch import settings
    from minivideo_tpu_torch.models.h264.decoder import (
        H264Decoder, decode_annexb, resolve_engine)
    assert settings.ENGINES == ("fused", "wave", "np")
    assert settings.get_infos()["engine"] == "fused"
    for name in settings.ENGINES:
        assert resolve_engine(name) == name
    assert resolve_engine("jax") == "fused"
    for bad in ("pallas", "lane", "", "NP"):
        with pytest.raises(ValueError):
            resolve_engine(bad)
        with pytest.raises(ValueError):
            H264Decoder(engine=bad, device="cpu")
    assert H264Decoder(engine="wave", device="cpu").engine == "wave"
    if not torch.cuda.is_available():
        data = make_stream(width_mbs=2, height_mbs=2, n_pictures=1, seed=36)
        for engine in settings.ENGINES:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                decode_annexb(data, engine=engine)


def test_feed_nalu_per_engine():
    """H264Decoder.feed_nalu returns each one-slice IDR picture under
    every engine, equal to the JAX package's feed_nalu under "np"."""
    from minivideo_tpu.models.h264.decoder import H264Decoder as JDec
    from minivideo_tpu_torch.models.h264.decoder import H264Decoder
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    data = make_stream(width_mbs=4, height_mbs=3, n_pictures=3, seed=37,
                       profile=100, transform_8x8=True, mb_kinds=KINDS,
                       allow_pcm=True)
    nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
    jdec = JDec(engine="np")
    want = [p for p in map(jdec.feed_nalu, nalus) if p is not None]
    assert len(want) == 3
    for engine in ("fused", "wave", "np"):
        dec = H264Decoder(engine=engine, device="cpu")
        got = [p for p in map(dec.feed_nalu, nalus) if p is not None]
        _same_pictures(want, got, engine)


# ---------------------------------------------------------------------------
# batch_thumbnail and the thumbnailer


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three 5x4-MB clips (ES, MP4, Matroska), two pictures each: one
    geometry bucket."""
    d = tmp_path_factory.mktemp("clips")
    kw = dict(width_mbs=5, height_mbs=4, n_pictures=2, profile=100,
              transform_8x8=True, mb_kinds=KINDS, allow_pcm=True)
    (d / "c0.264").write_bytes(make_stream(seed=38, **kw))
    (d / "c1.mp4").write_bytes(C.write_mp4(make_stream(seed=39, **kw),
                                           80, 64))
    (d / "c2.mkv").write_bytes(C.write_mkv(make_stream(seed=40, **kw),
                                           80, 64))
    return sorted(str(p) for p in d.iterdir())


def _files(outdir):
    return {f: open(os.path.join(outdir, f), "rb").read()
            for f in sorted(os.listdir(outdir)) if not f.endswith(".jsonl")}


@pytest.mark.parametrize("fmt,jax_engine", [("YUV420", "np"),
                                            ("PNG", "wave")])
def test_batch_thumbnail_engines(clips, tmp_path, fmt, jax_engine):
    """batch_thumbnail(engine="wave" and "np", device="cpu") writes the
    JAX package's files (its batch_thumbnail runs the wave engine for
    both names; "np" and the PNG of "np" convert RGB on the host)."""
    from minivideo_tpu.codecs import PictureFormat as JFmt
    from minivideo_tpu.parallel.batch import batch_thumbnail as j_batch
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch_thumbnail
    jdir = str(tmp_path / "jax")
    res = j_batch(clips, jdir, pictures_per_clip=2, fmt=JFmt[fmt],
                  engine=jax_engine)
    assert res.done == 3 and res.failed == 0
    want = _files(jdir)
    assert len(want) == 6
    for engine in ("wave", "np"):
        out = str(tmp_path / engine)
        res = batch_thumbnail(clips, out, pictures_per_clip=2,
                              fmt=PictureFormat[fmt], engine=engine,
                              device="cpu")
        assert res.done == 3 and res.failed == 0 and res.frames == 6
        got = _files(out)
        assert sorted(got) == sorted(want), engine
        for k in want:
            assert got[k] == want[k], f"{engine} {k}"


def test_thumbnailer_np_is_the_jax_app_s(tmp_path, capsys):
    """thumbnailer --engine np --device cpu against the JAX app --engine
    np, at an odd crop (both convert RGB on the host): PNG, BMP and
    YUV420 files equal byte for byte."""
    from minivideo_tpu.apps.thumbnailer import main as jax_main
    from minivideo_tpu_torch.apps.thumbnailer import main
    path = tmp_path / "clip.mp4"
    path.write_bytes(C.write_mp4(DECODE["odd_crop"][0](), 96, 64))
    for fmt in ("png", "bmp", "yuv420"):
        outs = []
        for app, extra, d in ((main, ["--device", "cpu"], "port"),
                              (jax_main, [], "jax")):
            outdir = str(tmp_path / fmt / d)
            rc = app(["-i", str(path), "-o", outdir, "-f", fmt, "-n", "2",
                      "--engine", "np"] + extra)
            assert rc == 0, capsys.readouterr().err
            outs.append(_files(outdir))
        capsys.readouterr()
        assert len(outs[1]) == 2 and outs[0] == outs[1], fmt


def test_cabac_bins_total_is_the_jax_package_s():
    """native.cabac_bins_total(): the bins the port's native parser
    decodes over one CABAC stream equal the JAX package's count."""
    from minivideo_tpu import native as jn
    from minivideo_tpu.models.h264.decoder import decode_annexb as j_decode
    from minivideo_tpu_torch import native
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    data = make_stream2(5, 4, 3, 41, entropy="cabac", mb_kinds=KINDS,
                        transform_8x8=True, density=0.5)
    b0 = native.cabac_bins_total()
    decode_annexb(data, engine="np", device="cpu")
    port_bins = native.cabac_bins_total() - b0
    j0 = jn.cabac_bins_total()
    j_decode(data, engine="np")
    assert port_bins == jn.cabac_bins_total() - j0 > 1000
    cavlc = make_stream(width_mbs=5, height_mbs=4, n_pictures=1, seed=42)
    b1 = native.cabac_bins_total()
    decode_annexb(cavlc, engine="np", device="cpu")
    assert native.cabac_bins_total() == b1

"""The port's entropy parsers equal the JAX package's, array by array of
FrameSyntax (tolerance 0): the Python CavlcSliceParser/CabacSliceParser,
the full native raster parse and the native slot-record parse, on small
CAVLC and CABAC streams with 8x8 transforms, I_PCM, 3 slices and custom
scaling lists; and chip_smoke.py's 1080p CABAC digests are the JAX
package's.  (torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import hashlib
import importlib
import sys

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2

STREAMS = {
    "cavlc": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=30, profile=100,
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3,
        allow_pcm=True, scaling_lists=[(1, None)] * 8,
        pps_scaling_lists=[(1, list(range(8, 24)))] * 6
        + [(1, list(range(6, 70)))] * 2),
    "cavlc_qp": lambda: make_stream(
        width_mbs=5, height_mbs=3, n_pictures=2, seed=31, qp=51,
        allow_pcm=True, n_slices=3),
    "cabac": lambda: make_stream2(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=32, entropy="cabac",
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3,
        allow_pcm=True),
}
ARRAYS = ("mb_kind", "qpy", "i16_mode", "chroma_mode", "luma4x4_modes",
          "luma8x8_modes", "cbp_luma", "cbp_chroma", "luma_dc", "luma_ac",
          "luma8x8_coeff", "chroma_dc", "chroma_ac", "total_coeff_luma",
          "total_coeff_chroma", "cbf_luma_dc", "cbf_luma", "cbf_luma8x8",
          "cbf_chroma_dc", "cbf_chroma", "transform8x8", "parsed")


def _mods(pkg):
    base = f"{pkg}.models.h264."
    return {m: importlib.import_module(base + m)
            for m in ("decoder", "nalu", "slicehdr", "syntax", "cabac")}


def _pictures(pkg, data):
    """[(sps, pps, [(nalu, slice header), ...]) per picture] of `data`,
    parsed with package `pkg`'s own header parsers."""
    m = _mods(pkg)
    dec = m["decoder"].H264Decoder(
        **({"device": "cpu"} if pkg == "minivideo_tpu_torch" else {}))
    nalus = [m["nalu"].parse_nalu(raw, off)
             for off, raw in m["nalu"].split_annexb(data)]
    for n in nalus:
        if n.nal_unit_type in (7, 8):
            dec.feed_nalu(n)
    out = []
    for group in m["decoder"].group_idr_access_units(nalus):
        hs = [m["slicehdr"].parse_slice_header(
            n.rbsp, n.nal_unit_type, n.nal_ref_idc, dec.sps_map,
            dec.pps_map) for n in group]
        out.append((hs[0][1], hs[0][2],
                    [(n, h[0]) for n, h in zip(group, hs)]))
    return out


def _parse(pkg, data, how):
    """Per picture, the FrameSyntax that `how` fills: "python" (the
    CAVLC/CABAC parser classes), "native" (the raster parse) or
    "records" (the slot-record parse, with its slab staging)."""
    m = _mods(pkg)
    native = importlib.import_module(pkg + ".native")
    recon = importlib.import_module(pkg + ".ops.recon")
    bitio = importlib.import_module(pkg + ".bitio")
    pics = _pictures(pkg, data)
    sps0 = pics[0][0]
    wmb, hmb = sps0.pic_width_in_mbs, sps0.pic_height_in_map_units
    staging = recon.make_slab_staging(wmb, hmb, len(pics))
    out = []
    for i, (sps, pps, slices) in enumerate(pics):
        fs = m["syntax"].FrameSyntax(wmb, hmb, lite=how == "records")
        for nalu, sh in slices:
            args = (nalu.rbsp, sh.data_bit_offset, sh.first_mb_in_slice,
                    sh.qp, bool(pps.entropy_coding_mode_flag),
                    bool(pps.transform_8x8_mode_flag))
            if how == "native":
                n = native.parse_slice_native(fs, *args)
            elif how == "records":
                n = native.parse_slice_native_slab(fs, staging, i, *args)
            elif pps.entropy_coding_mode_flag:
                n = m["cabac"].CabacSliceParser(nalu.rbsp, sh, sps, pps,
                                                fs).parse_slice_data()
            else:
                r = bitio.BitReader(nalu.rbsp, start_bit=sh.data_bit_offset)
                n = m["syntax"].CavlcSliceParser(r, sh, sps, pps,
                                                 fs).parse_slice_data()
            assert n > 0
        out.append(fs)
    return out, staging


def _assert_syntax_equal(want, got, what):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name),
                                      err_msg=f"{what} {name}")
    for name in ("pcm_y", "pcm_cb", "pcm_cr"):
        w, g = getattr(want, name), getattr(got, name)
        assert sorted(w) == sorted(g), f"{what} {name}"
        for mb in w:
            np.testing.assert_array_equal(w[mb], g[mb])


@pytest.mark.parametrize("how", ["python", "native", "records"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_matches_jax(name, how):
    data = STREAMS[name]()
    want, wst = _parse("minivideo_tpu", data, how)
    got, gst = _parse("minivideo_tpu_torch", data, how)
    assert len(want) == len(got) == 2
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.parsed.all() and g.parsed.all()
        _assert_syntax_equal(w, g, f"{name} {how} pic {i}")
    if how == "records":
        for k in ("luma_slab", "chroma_slab", "dc_slab"):
            np.testing.assert_array_equal(wst[k], gst[k], err_msg=k)
        assert wst["maxw"] == gst["maxw"]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_parse_packs_like_python_parser(name):
    """Within the port, the native raster parse and the Python parsers
    give the same raster staging (pack_frames) and I_PCM samples: the
    native parse keeps the samples in the coefficient buffers too."""
    from minivideo_tpu_torch.ops.recon import pack_frames
    data = STREAMS[name]()
    py, _ = _parse("minivideo_tpu_torch", data, "python")
    nat, _ = _parse("minivideo_tpu_torch", data, "native")
    sps, pps, _ = _pictures("minivideo_tpu_torch", data)[0]
    want, got = (pack_frames([(fs, None) for fs in f], sps, pps)
                 for f in (py, nat))
    assert sorted(want.arrays) == sorted(got.arrays)
    for k in want.arrays:
        np.testing.assert_array_equal(want.arrays[k], got.arrays[k],
                                      err_msg=f"{name} {k}")
    assert any(fs.pcm_y for fs in nat)
    for p, n in zip(py, nat):
        for k in ("pcm_y", "pcm_cb", "pcm_cr"):
            assert sorted(getattr(p, k)) == sorted(getattr(n, k))
            for mb, pix in getattr(p, k).items():
                np.testing.assert_array_equal(pix, getattr(n, k)[mb])


def test_chip_smoke_cabac_digests_are_the_jax_package_s(monkeypatch):
    """The 1080p CABAC stream's SHA-256 and the plane digests pinned in
    chip_smoke.py are what the fixture encoder and the JAX package's fused
    engine give (the port's decode of the stream is held against them on
    the card, in chip_smoke.py; the port's CABAC parse against the JAX
    package's, above)."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke
    from minivideo_tpu.models.h264.decoder import decode_annexb
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "device")
    data = make_stream2(**chip_smoke.CABAC_KW)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.CABAC_SHA256

    def digests(pics):
        return [[hashlib.sha256(np.ascontiguousarray(a).tobytes())
                 .hexdigest() for a in (p.y, p.cb, p.cr)] for p in pics]

    assert digests(decode_annexb(data, engine="fused")) == \
        chip_smoke.CABAC_DIGESTS
    assert len(chip_smoke.CABAC_DIGESTS) == chip_smoke.CABAC_KW["n_pictures"]


@pytest.mark.parametrize("case", ["edges", "random", "x264_1080p"])
def test_unescape_rbsp_equals_jax_package(case):
    """The port's RBSP unescape (bytes.find from one 00 00 03 to the next)
    gives the bytes of the JAX package's byte-by-byte loop: on runs of
    zeros and threes that overlap and sit at either end, on random bytes
    dense in 0 and 3, and on every NAL of a committed libx264 1080p
    picture (a 1 MB slice with emulation-prevention bytes, which the
    loop walks whole)."""
    from minivideo_tpu.models.h264.nalu import unescape_rbsp as want
    from minivideo_tpu_torch.models.h264.nalu import (split_annexb,
                                                      unescape_rbsp)
    if case == "edges":
        units = [b"", b"\x03", b"\x00\x00", b"\x00\x00\x03",
                 b"\x00\x00\x03\x00\x00\x03", b"\x00\x00\x00\x03\x03",
                 b"\x00\x00\x03\x00\x00\x00\x03\x01", b"\x01\x00\x00\x03",
                 b"\x00\x00\x03\x00", b"\x00\x03\x00\x00\x03\x03\x00\x00"]
    elif case == "random":
        rng = np.random.default_rng(13)
        units = [rng.choice(np.array([0, 0, 0, 3, 1, 255], np.uint8),
                            size=int(n)).tobytes()
                 for n in rng.integers(0, 4000, size=40)]
    else:
        from minivideo_tpu_torch.testing import streams as st
        units = [u for _, u in split_annexb(st.x264_1080p("cavlc"))]
        assert max(len(u) for u in units if b"\x00\x00\x03" in u) > 10**6
    for u in units:
        assert unescape_rbsp(u) == want(u), u[:16]

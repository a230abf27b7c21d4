"""Real-encoder parity of the port: tests/test_golden_x264.py's libx264
streams, decoded by the port's decode_annexb(device="cpu") and held bit
for bit to libavcodec's display-cropped planes.

The streams carry syntax the repo's own encoders never emit: mixed 3-
and 4-byte start codes, SEI between pictures, repeated parameter sets,
slice_type 7.  Each stream is also decoded with every start code
rewritten to 4 bytes, and must give the same pictures.  The fused engine
(its plain version on the CPU) runs on every stream; "wave" and "np"
only on the small ones (np costs ~10 s a 1080p picture).

The tools (tools/x264_fixture.c, tools/h264_lavc_decode.c) are built by
minivideo_tpu_torch/testing/x264.py; every test skips where they do not
build (no libavcodec).  torch and the port are imported inside the
tests (see torch_port_helpers.py).
"""

import hashlib

import numpy as np
import pytest

SMALL = ("fused", "wave", "np")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these loops of small torch ops run faster on
    one, and the suite's parallel workers share the host's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x264():
    from minivideo_tpu_torch.testing import x264 as tools
    try:
        tools.encoder()
        tools.decoder()
    except RuntimeError as e:
        pytest.skip(f"libx264/libavcodec tools unavailable: {e}")
    return tools


def _check(x264, data, n_pics, engines=("fused",)):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    theirs = x264.lavc_decode(data)
    assert len(theirs) == n_pics
    first = None
    for engine in engines:
        mine = decode_annexb(data, engine=engine, device="cpu")
        assert len(mine) == n_pics, engine
        for i, (p, ref) in enumerate(zip(mine, theirs)):
            for name, a, b in zip(("Y", "Cb", "Cr"), p.cropped(), ref):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{engine} {name} pic {i}")
        first = first or mine
    # framing invariance: mixed 3-/4-byte start codes vs all 4-byte
    norm = decode_annexb(x264.normalize_startcodes(data),
                         engine=engines[0], device="cpu")
    assert len(norm) == n_pics
    for a, b in zip(first, norm):
        for pa, pb in zip((a.y, a.cb, a.cr), (b.y, b.cb, b.cr)):
            np.testing.assert_array_equal(pa, pb)


def test_x264_cavlc_baseline(x264):
    _check(x264, x264.x264_stream(96, 64, 2, 28, 0, 0, 7), 2, SMALL)


def test_x264_cavlc_high_8x8(x264):
    _check(x264, x264.x264_stream(128, 96, 2, 24, 0, 1, 11), 2, SMALL)


def test_x264_cabac(x264):
    _check(x264, x264.x264_stream(96, 64, 2, 26, 1, 0, 13), 2, SMALL)


def test_x264_cabac_8x8_qp_low(x264):
    _check(x264, x264.x264_stream(112, 80, 2, 18, 1, 1, 17), 2, SMALL)


def test_x264_qp_high(x264):
    _check(x264, x264.x264_stream(96, 64, 2, 44, 1, 1, 19), 2, SMALL)


def test_x264_cropped_dimensions(x264):
    """Non-MB-multiple frame size -> SPS cropping exercised."""
    _check(x264, x264.x264_stream(100, 70, 1, 26, 1, 0, 29), 1, SMALL)


def test_x264_jax_engine_matches(x264):
    """"jax", the JAX package's production engine name, is the port's
    fused engine."""
    _check(x264, x264.x264_stream(96, 64, 2, 28, 1, 1, 23), 2, ("jax",))


def test_x264_multislice_cavlc(x264):
    """4 slices per picture: entropy state and neighbour availability
    reset at slice boundaries."""
    _check(x264, x264.x264_stream(128, 96, 2, 26, 0, 0, 31, slices=4), 2,
           SMALL)


def test_x264_multislice_cabac_8x8(x264):
    _check(x264, x264.x264_stream(128, 96, 2, 24, 1, 1, 37, slices=4), 2,
           SMALL)


def test_x264_multislice_jax_engine(x264):
    _check(x264, x264.x264_stream(128, 96, 1, 26, 1, 0, 41, slices=3), 1,
           ("jax",))


def test_x264_1080p_real_content(x264):
    """1920x1080 (SPS cropping) at QP 26, CAVLC and CABAC with 8x8: the
    committed streams of testing/streams.X264_1080P (their provenance:
    test_committed_1080p_streams_are_x264_s)."""
    from minivideo_tpu_torch.testing import streams
    for name in ("cavlc", "cabac_8x8"):
        _check(x264, streams.x264_1080p(name), 1)


def test_x264_1080p_multislice(x264):
    """1080p with 4 slices per picture, CABAC with 8x8 (committed)."""
    from minivideo_tpu_torch.testing import streams
    _check(x264, streams.x264_1080p("cabac_8x8_4slices"), 1)


def test_committed_1080p_streams_are_x264_s(x264):
    """The 1080p streams that chip_smoke.py decodes on the card (its host
    has no libavcodec) are what x264_stream(1920, 1080, 1, 26, ...)
    writes here, byte for byte, and libavcodec gives their pinned
    digests."""
    from minivideo_tpu_torch.testing import streams

    for name, (_, (cabac, dct8, seed, slices), _, want) in \
            streams.X264_1080P.items():
        data = streams.x264_1080p(name)
        assert x264.x264_stream(1920, 1080, 1, 26, cabac, dct8, seed,
                                slices=slices) == data, name
        pics = x264.lavc_decode(data)
        assert [[hashlib.sha256(np.ascontiguousarray(a).tobytes())
                 .hexdigest() for a in p] for p in pics] == [want], name


def test_committed_x264_stream_is_libavcodec_s(x264):
    """testing/x264_128x96_cabac8x8_s4.264, which chip_smoke.py decodes on
    the card (its host has no libavcodec): the pinned SHA-256, libavcodec
    gives the pinned digests, and so do the port's three engines."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing import streams
    with open(streams.X264_STREAM, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == streams.X264_SHA256

    def digests(pics):
        return [[hashlib.sha256(np.ascontiguousarray(a).tobytes())
                 .hexdigest() for a in p] for p in pics]

    assert digests(x264.lavc_decode(data)) == streams.X264_LAVC_DIGESTS
    for engine in SMALL:
        pics = decode_annexb(data, engine=engine, device="cpu")
        assert digests([p.cropped() for p in pics]) == \
            streams.X264_LAVC_DIGESTS, engine

"""The port's decode_annexb(device="cpu") equals the JAX package's
decode_annexb(engine="fused") with device-layout staging, bit for bit:
CAVLC, CABAC, 8x8, multi-slice, scaling lists and cropped streams.
(torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from minivideo_tpu.models.h264.decoder import decode_annexb as j_decode
from torch_port_helpers import assert_planes_equal

STREAMS = {
    "cavlc": lambda: make_stream(width_mbs=5, height_mbs=4, n_pictures=3,
                                 seed=1, allow_pcm=True),
    "cavlc_8x8_slices": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=2, profile=100,
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3),
    "cabac": lambda: make_stream2(width_mbs=5, height_mbs=3, n_pictures=2,
                                  seed=3, entropy="cabac",
                                  mb_kinds=("i16", "i4")),
    "cabac_8x8_pcm": lambda: make_stream2(
        width_mbs=4, height_mbs=4, n_pictures=3, seed=4, entropy="cabac",
        mb_kinds=("i16", "i4", "i8"), transform_8x8=True, allow_pcm=True,
        n_slices=2),
    "scaling_lists": lambda: make_stream(
        width_mbs=4, height_mbs=3, n_pictures=2, seed=5, profile=100,
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"),
        scaling_lists=[(1, None)] * 8,
        pps_scaling_lists=[(1, list(range(8, 24)))] * 6
        + [(1, list(range(6, 70)))] * 2),
    "cropped": lambda: make_stream(width_mbs=5, height_mbs=3, n_pictures=2,
                                   seed=6, crop=(1, 2, 0, 3)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_matches_jax(name, monkeypatch):
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "device")
    data = STREAMS[name]()
    want = j_decode(data, engine="fused")
    got = tdec.decode_annexb(data, device="cpu")
    assert len(want) == len(got) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert (w.width, w.height) == (g.width, g.height)
        assert w.idr_index == g.idr_index
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr),
                            f"{name} pic {i}")
        assert_planes_equal(w.cropped(), g.cropped(), f"{name} crop {i}")
        assert g.y.dtype == np.uint8


def test_max_pictures(monkeypatch):
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "device")
    data = make_stream(width_mbs=3, height_mbs=2, n_pictures=4, seed=7)
    want = j_decode(data, max_pictures=2, engine="fused")
    got = tdec.decode_annexb(data, max_pictures=2, device="cpu")
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr))


def test_feed_nalu_single_idr():
    """One IDR NALU through feed_nalu decodes like decode_annexb."""
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    data = make_stream(width_mbs=3, height_mbs=3, n_pictures=1, seed=8)
    dec = tdec.H264Decoder(device="cpu")
    pics = [dec.feed_nalu(parse_nalu(raw, off))
            for off, raw in split_annexb(data)]
    pics = [p for p in pics if p is not None]
    want = tdec.decode_annexb(data, device="cpu")
    assert len(pics) == 1
    assert_planes_equal((want[0].y, want[0].cb, want[0].cr),
                        (pics[0].y, pics[0].cb, pics[0].cr))


def test_default_device_needs_cuda():
    """device=None asks for the GPU: without one it raises instead of
    decoding on the CPU."""
    import torch
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    if torch.cuda.is_available():
        assert tdec.resolve_device(None).type == "cuda"
        return
    data = make_stream(width_mbs=2, height_mbs=2, n_pictures=1, seed=9)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.decode_annexb(data)


def test_engines():
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    assert tdec.resolve_engine("fused") == "fused"
    assert tdec.resolve_engine("jax") == "fused"
    for engine in ("wave", "np"):
        assert tdec.resolve_engine(engine) == engine
    for engine in ("bogus", "pallas"):
        with pytest.raises(ValueError):
            tdec.resolve_engine(engine)

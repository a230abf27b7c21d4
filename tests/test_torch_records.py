"""The device staging mode's MB-major records (native.REC_*), byte for
byte against the JAX package's device layout, on the CPU:

  * the port's records of a CABAC 8x8, a CAVLC, a 4-slice (libx264) and
    an I_PCM stream, laid out by the plain gather
    (ops/wave_layout.wave_layout_plain), are the feeds and meta rows that
    minivideo_tpu.native.parse_slice_native_slab2 writes;
  * records parsed onto staging full of non-zero bytes lay out as those
    parsed onto fresh staging, where a cut slice leaves MBs unwritten too;
  * the plain gather is the skew definition, padding lanes and meta rows
    34..39 zero, with and without `out=`; the kernel's wrapper takes
    only CUDA tensors (the kernel is held to the gather on the card, in
    test_torch_gpu_bench.py).
torch and the port are imported inside the tests (see
torch_port_helpers.py).
"""

import os

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from torch_port_helpers import jax_packed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x264_s4():
    path = os.path.join(REPO, "minivideo_tpu_torch", "testing",
                        "x264_128x96_cabac8x8_s4.264")
    with open(path, "rb") as f:
        return f.read()


STREAMS = {
    "cabac8x8": lambda: make_stream2(
        width_mbs=7, height_mbs=5, n_pictures=2, seed=41, entropy="cabac",
        mb_kinds=("i16", "i4", "i8"), transform_8x8=True, density=0.5),
    "cavlc": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=3, seed=42, profile=100,
        mb_kinds=("i16", "i4", "i8"), transform_8x8=True, n_slices=2,
        allow_pcm=False, qp=40),
    "slices4": _x264_s4,
    "ipcm": lambda: make_stream2(
        width_mbs=9, height_mbs=6, n_pictures=3, seed=43, entropy="cabac",
        mb_kinds=("i16", "i4"), allow_pcm=True),
}


def _port_packed(data):
    """The port's device-mode PackedFrames of `data` on the CPU."""
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    (parsed, packed), = stage_annexb(data, "cpu", staging_mode="device")
    assert packed.slots == 2 and sorted(packed.arrays) == ["records"]
    return packed


def _laid_out(packed):
    from minivideo_tpu_torch.ops.recon_fused import DEVICE_STAGING
    from minivideo_tpu_torch.ops.wave_layout import wave_layout_plain
    feeds = wave_layout_plain(packed.arrays["records"], packed.wmb,
                              packed.hmb)
    return {k: f.numpy() for k, f in zip(DEVICE_STAGING, feeds)}


def _same_bytes(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_records_lay_out_to_the_jax_feeds(name):
    from minivideo_tpu_torch.native import REC_LEN, REC_META
    from minivideo_tpu_torch.ops.slab import R_PARSED
    data = STREAMS[name]()
    jp, _, _, _ = jax_packed(data, "device")
    tp = _port_packed(data)
    recs = tp.arrays["records"].numpy()
    assert recs.shape == (jp.batch, tp.wmb * tp.hmb, REC_LEN)
    assert (recs[:, :, REC_META + R_PARSED] == 1).all()
    assert tp.haspcm == jp.haspcm == (name == "ipcm")
    _same_bytes(_laid_out(tp), jp.arrays)


def test_dirty_staging_lays_out_as_fresh(monkeypatch):
    """The decoder's staging filled with 0x5A bytes before the parse: a
    two-slice stream, and a picture whose one slice, cut, parses without
    error but leaves its last 16 MBs unwritten (zeroed by zero_uncovered)
    beside whole ones, lay out as on fresh staging and as the JAX
    package's feeds."""
    import torch
    from minivideo_tpu_torch.models.h264 import decoder
    from minivideo_tpu_torch.testing.streams import cut_idr
    from minivideo_tpu_torch.ops import recon
    short = cut_idr(make_stream2(
        width_mbs=6, height_mbs=4, n_pictures=3, seed=82, n_slices=1,
        mb_kinds=("i16", "i4", "i8"), transform_8x8=True, allow_pcm=True),
        picks=(0,), keep=0.46)
    fresh = recon.make_slab_staging2
    for data in (STREAMS["cavlc"](), short):
        want = _laid_out(_port_packed(data))
        _same_bytes(want, jax_packed(data, "device")[0].arrays)

        def dirty(*a):
            staging = fresh(*a)
            staging["records"].view(np.uint8)[...] = 0x5A
            return staging

        zeroed = []
        real = recon.zero_uncovered

        def counted(staging, soms):
            zeroed.append(real(staging, soms))
            return zeroed[-1]

        with monkeypatch.context() as mp:
            mp.setattr(decoder, "make_slab_staging2", dirty)
            mp.setattr(decoder, "zero_uncovered", counted)
            tp = _port_packed(data)
        assert zeroed == [16 if data is short else 0]
        assert isinstance(tp.arrays["records"], torch.Tensor)
        _same_bytes(_laid_out(tp), want)


@pytest.mark.parametrize("wmb,hmb,batch", [(7, 5, 2), (1, 3, 1),
                                           (120, 3, 1)])
def test_plain_gather_is_the_skew_definition(wmb, hmb, batch):
    import torch
    from minivideo_tpu_torch.native import REC_LEN
    from minivideo_tpu_torch.ops.recon_wave import skew_tables
    from minivideo_tpu_torch.ops.wave_layout import (empty_feeds, wave_layout,
                                                     wave_layout_cuda,
                                                     wave_layout_plain)
    g = skew_tables(wmb, hmb)
    rng = np.random.default_rng(wmb * 100 + hmb)
    recs = rng.integers(-2**15, 2**15, (batch, wmb * hmb, REC_LEN),
                        dtype=np.int16)
    meta, luma, chroma, dc = (f.numpy() for f in wave_layout_plain(
        torch.from_numpy(recs), wmb, hmb))
    assert (meta.dtype, luma.dtype) == (np.int32, np.int16)
    W, maxw = g["n_waves"], g["maxw"]
    for b in range(batch):
        for w in range(W):
            for k in range(maxw):
                if not g["skew_valid"][w, k]:
                    for f in (meta, luma, chroma, dc):
                        assert not f[b, w, :, k].any()
                    continue
                r = recs[b, g["skew_idx"][w, k]]
                np.testing.assert_array_equal(luma[b, w, :, k], r[:256])
                np.testing.assert_array_equal(chroma[b, w, :, k],
                                              r[256:384])
                np.testing.assert_array_equal(dc[b, w, :, k], r[384:416])
                np.testing.assert_array_equal(meta[b, w, :34, k],
                                              r[416:450])
                assert not meta[b, w, 34:, k].any()
    out = empty_feeds(wmb, hmb, batch, "cpu")
    got = wave_layout(torch.from_numpy(recs), wmb, hmb, out=out)
    assert all(a is b for a, b in zip(got, out))
    for a, b in zip(got, (meta, luma, chroma, dc)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="CUDA"):
        wave_layout_cuda(torch.from_numpy(recs), wmb, hmb)
    with pytest.raises(ValueError, match="shape"):
        wave_layout_plain(torch.from_numpy(recs[:, 1:]), wmb, hmb)

"""GPU cases of the port's staging layouts, Python parsers and bad-slice
handling: decodes on the card (the CUDA kernel behind the records and
raster feeds, the Python parsers, streams with bad IDR pictures) equal the
plain version's on the CPU, with tolerance 0.  Each test skips without a
CUDA card and carries the `cuda` marker registered in pyproject.toml.
Like test_torch_gpu.py, this file imports neither JAX nor the JAX package
and runs on the GPU host with

    python -m pytest --noconftest tests/test_torch_gpu_feeds.py

torch and the port are imported by the `cuda` fixture and inside the
tests, not at collection (see torch_port_helpers.py).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

STREAMS = {
    "cavlc": dict(width_mbs=7, height_mbs=5, n_pictures=3, seed=60,
                  profile=100, transform_8x8=True,
                  mb_kinds=("i16", "i4", "i8"), n_slices=3, allow_pcm=True),
    "cabac": dict(width_mbs=7, height_mbs=5, n_pictures=3, seed=61,
                  entropy="cabac", transform_8x8=True,
                  mb_kinds=("i16", "i4", "i8"), n_slices=3, allow_pcm=True),
}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(name):
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    return (make_stream2 if name == "cabac" else make_stream)(
        **STREAMS[name])


def _decode(data, device, layout):
    """Decode `data` on `device` through staging `layout`: "device" and
    "records" by MINIVIDEO_TPU_STAGING, "raster" by the full native parse,
    pack_frames and reconstruct_batch."""
    from minivideo_tpu_torch.models.h264.decoder import (H264Decoder,
                                                        stage_annexb)
    parts = stage_annexb(data, device, staging_mode=layout)
    dec = H264Decoder(device=device)
    return [p for parsed, packed in parts
            for p in dec.reconstruct_batch(parsed, packed)]


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.y, w.y), (g.cb, w.cb), (g.cr, w.cr)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["device", "records", "raster"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_layout_on_card_equals_plain(name, layout, cuda):
    from minivideo_tpu_torch.ops import recon_fused
    data = _stream(name)
    recon_fused.wave_kernel_cuda.launches = 0
    got = _decode(data, cuda, layout)
    assert recon_fused.wave_kernel_cuda.launches == 1
    _assert_same(got, _decode(data, "cpu", layout))


@pytest.mark.parametrize("layout", ["device", "records"])
def test_decode_annexb_staging_env(layout, cuda, monkeypatch):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.ops import recon_fused
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", layout)
    data = _stream("cavlc")
    recon_fused.wave_kernel_cuda.launches = 0
    got = decode_annexb(data)
    assert recon_fused.wave_kernel_cuda.launches == 1
    _assert_same(got, decode_annexb(data, device="cpu"))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_python_parsers_on_card(name, cuda, monkeypatch):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    data = _stream(name)
    native = decode_annexb(data)
    monkeypatch.setenv("MINIVIDEO_TPU_NO_NATIVE", "1")
    _assert_same(decode_annexb(data), native)


@pytest.mark.parametrize("name", ["truncated_idr", "joined_id0",
                                  "error_run"])
def test_bad_slices_on_card(name, cuda):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import bad_stream
    data = bad_stream(name, make_stream)
    _assert_same(decode_annexb(data), decode_annexb(data, device="cpu"))


def test_feeds_on_card_equal_cpu(cuda):
    """The raster and records feeds, as torch ops on the card, give the
    CPU's tensors bit for bit."""
    import torch
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops import recon_fused
    data = _stream("cavlc")
    for layout, feeds in (("raster", recon_fused.raster_feeds),
                          ("records", recon_fused.records_feeds)):
        outs = []
        for device in (cuda, "cpu"):
            (_, p), = stage_annexb(data, device, staging_mode=layout)
            outs.append(feeds(p.arrays, *p.chroma_qp_off, p.wmb, p.hmb,
                              p.batch))
        for g, w in zip(*outs):
            assert g.is_cuda and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)

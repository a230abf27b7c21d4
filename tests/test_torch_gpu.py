"""GPU cases of the port: the CUDA wave kernel against its plain PyTorch
version on the card, with tolerance 0.  Each test skips without a CUDA
card (the kernel has no CPU mode) and carries the `cuda` marker
registered in pyproject.toml.  This file imports neither JAX nor
the JAX package, so it runs on the GPU host, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py

torch and the port are imported by the `cuda` fixture, not at collection
(see torch_port_helpers.py).
"""

import pytest

pytestmark = pytest.mark.cuda

STREAMS = {
    "kinds_pcm": dict(width_mbs=7, height_mbs=5, n_pictures=3, seed=40,
                      mb_kinds=("i16", "i4"), allow_pcm=True),
    "i8_slices": dict(width_mbs=7, height_mbs=5, n_pictures=3, seed=41,
                      profile=100, transform_8x8=True,
                      mb_kinds=("i16", "i4", "i8"), n_slices=2),
    "qp51": dict(width_mbs=5, height_mbs=6, n_pictures=2, seed=42, qp=51,
                 profile=100, transform_8x8=True, mb_kinds=("i8", "i4")),
    "qp0_pcm": dict(width_mbs=6, height_mbs=3, n_pictures=2, seed=43, qp=0,
                    allow_pcm=True, mb_kinds=("i16",)),
    "odd": dict(width_mbs=1, height_mbs=1, n_pictures=3, seed=44),
}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _staging(data, device):
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    (_, packed, arrs), = stage_annexb(data, device)
    return packed, arrs


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_kernel_matches_plain(name, cuda):
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.testing.h264enc import make_stream
    packed, arrs = _staging(make_stream(**STREAMS[name]), cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    got = tfused.wave_kernel_cuda(*args, **kw)
    want = tfused.reconstruct_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == w.shape
        assert torch.equal(g, w)


def test_decode_on_card_counts_launches(cuda):
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.ops.recon_wave import skew_tables
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(**STREAMS["i8_slices"])
    tfused.wave_kernel_cuda.launches = 0
    got = tdec.decode_annexb(data)
    assert tfused.wave_kernel_cuda.launches == skew_tables(7, 5)["n_waves"]
    want = tdec.decode_annexb(data, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in ((g.y, w.y), (g.cb, w.cb), (g.cr, w.cr)):
            assert (a == b).all()


def test_wrapper_rejects_bad_tensors(cuda):
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.testing.h264enc import make_stream
    packed, arrs = _staging(make_stream(**STREAMS["kinds_pcm"]), cuda)
    meta, luma, chroma, dc = arrs
    rest = (packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    with pytest.raises(TypeError):
        tfused.wave_kernel_cuda(meta, luma.to(torch.int32), chroma, dc,
                                *rest)
    with pytest.raises(ValueError):
        tfused.wave_kernel_cuda(meta, luma, chroma[:, :, :64], dc, *rest)
    with pytest.raises(ValueError):
        tfused.wave_kernel_cuda(meta.transpose(2, 3).contiguous()
                                .transpose(2, 3), luma, chroma, dc, *rest)

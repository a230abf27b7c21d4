"""GPU cases of the port's wave and lane loops: on the card they give the
CPU's planes (tolerance 0), with no launch of the fused kernel.  Each
test skips without a CUDA card and carries the `cuda` marker registered
in pyproject.toml.  This file imports neither JAX nor the JAX package, so
it runs on the GPU host, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu_engines.py

torch and the port are imported by the `cuda` fixture and the tests, not
at collection (see torch_port_helpers.py).
"""

import pytest

pytestmark = pytest.mark.cuda

STREAMS = {
    "kinds_pcm_slices": dict(width_mbs=7, height_mbs=5, n_pictures=3,
                             seed=50, profile=100, transform_8x8=True,
                             mb_kinds=("i16", "i4", "i8"), allow_pcm=True,
                             n_slices=2),
    "qp51_crop": dict(width_mbs=5, height_mbs=6, n_pictures=2, seed=51,
                      qp=51, mb_kinds=("i16", "i4"), crop=(1, 2, 0, 3)),
}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _raster(name, device):
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.testing.h264enc import make_stream
    (_, packed), = stage_annexb(make_stream(**STREAMS[name]), device,
                                staging_mode="raster")
    return packed


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_wave_lane_residuals_on_card_equal_cpu(name, cuda):
    import torch
    from minivideo_tpu_torch.ops.recon import build_residuals
    from minivideo_tpu_torch.ops.recon_lane import reconstruct_frames_lane
    from minivideo_tpu_torch.ops.recon_wave import reconstruct_frames_wave
    gpu, cpu = _raster(name, cuda), _raster(name, "cpu")
    want = reconstruct_frames_wave(cpu, "cpu")
    for fn in (reconstruct_frames_wave, reconstruct_frames_lane):
        got = fn(gpu)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == torch.uint8
            assert torch.equal(g.cpu(), w)
    res = [build_residuals(p.arrays, p.ls4, p.ls8, *p.chroma_qp_off)
           for p in (gpu, cpu)]
    for k in res[1]:
        assert torch.equal(res[0][k].cpu(), res[1][k]), k


def test_decode_engines_on_card(cuda):
    """decode_annexb(engine="wave") on the card: the CPU's pictures and
    no launch of the fused kernel; "np" resolves the card and gives the
    same pictures."""
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(**STREAMS["kinds_pcm_slices"])
    want = tdec.decode_annexb(data, device="cpu")
    tfused.wave_kernel_cuda.launches = 0
    for engine in ("wave", "np"):
        got = tdec.decode_annexb(data, engine=engine, want_rgb=True)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in ((g.y, w.y), (g.cb, w.cb), (g.cr, w.cr)):
                assert (a == b).all()
            assert (g.rgb is None) == (engine == "np")
    assert tfused.wave_kernel_cuda.launches == 0

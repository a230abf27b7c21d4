"""The port's fused engine (plain wave loop on the CPU) equals the JAX
package's fused Pallas engine (interpret mode) and the numpy oracle, bit
for bit, on identical v2 staging carried across by packed_from_numpy:
every MB kind, I8x8, PCM, QP extremes, multi-slice, batches of 3+.
(The CUDA kernel is held against the plain loop in test_torch_gpu.py;
torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import dataclasses

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from minivideo_tpu.models.h264.recon_np import reconstruct_frame
from minivideo_tpu.ops.recon_fused import (
    make_reconstruct_fused_slots2 as j_make_slots2,
    reconstruct_frames_fused as j_recon)
from tests.test_recon_jax import _parse_stream
from torch_port_helpers import assert_planes_equal, jax_packed


def _compare(data):
    import torch
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, _, _, _ = jax_packed(data)
    want = [np.asarray(a) for a in j_recon(packed, interpret=True)]
    got = tfused.reconstruct_frames_fused(
        packed_from_numpy(packed, device="cpu"))
    assert all(g.dtype == torch.uint8 and g.device.type == "cpu"
               for g in got)
    assert_planes_equal(want, got, "fused vs JAX fused")
    frames, sps, pps = _parse_stream(data)
    for i, (fs, som) in enumerate(frames):
        assert_planes_equal(reconstruct_frame(fs, sps, pps, som),
                            [p[i] for p in got], f"oracle pic {i}")


@pytest.mark.parametrize("kinds", [("i16",), ("i4",), ("i16", "i4")])
def test_fused_kinds(kinds):
    # 3 pictures: the lane axis holds >2 frame segments
    _compare(make_stream(width_mbs=5, height_mbs=4, n_pictures=3, seed=33,
                         mb_kinds=kinds, density=0.4, allow_pcm=True))


def test_fused_i8():
    _compare(make_stream(width_mbs=5, height_mbs=4, n_pictures=2, seed=34,
                         mb_kinds=("i16", "i4", "i8"), density=0.4,
                         transform_8x8=True, profile=100, allow_pcm=False))


@pytest.mark.parametrize("qp", [0, 12, 51])
def test_fused_qp_extremes(qp):
    _compare(make_stream(width_mbs=4, height_mbs=3, n_pictures=2, seed=70,
                         qp=qp, mb_kinds=("i16", "i4"), density=0.5,
                         allow_pcm=False))


def test_fused_multi_slice():
    _compare(make_stream(width_mbs=4, height_mbs=4, n_pictures=3, seed=71,
                         n_slices=3, mb_kinds=("i16", "i4"), density=0.4,
                         allow_pcm=False))


def test_fused_all_kinds_mixed():
    _compare(make_stream(width_mbs=5, height_mbs=4, n_pictures=3, seed=55,
                         mb_kinds=("i16", "i4", "i8"), density=0.45,
                         transform_8x8=True, profile=100, allow_pcm=True))


@pytest.mark.parametrize("wmb,hmb,npic", [(9, 2, 1), (2, 7, 2), (1, 1, 3)])
def test_fused_odd_geometry(wmb, hmb, npic):
    _compare(make_stream(width_mbs=wmb, height_mbs=hmb, n_pictures=npic,
                         seed=80 + wmb, mb_kinds=("i16", "i4"), density=0.4,
                         allow_pcm=False))


def test_fused_specialized_flags():
    """has8x8=False / haspcm=False: the JAX kernel's specialised variant
    and the port's plain loop agree on a stream without 8x8 or PCM."""
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops import recon_fused as tfused
    data = make_stream(width_mbs=5, height_mbs=3, n_pictures=2, seed=91,
                       mb_kinds=("i16", "i4"), density=0.4, allow_pcm=False)
    packed, _, _, _ = jax_packed(data)
    assert packed.has8x8 is False and packed.haspcm is False
    a = packed.arrays
    fn = j_make_slots2(packed.wmb, packed.hmb, packed.batch, interpret=True,
                       has8x8=False, haspcm=False)
    want = [np.asarray(x) for x in fn(a["meta_slab"], a["luma_slab"],
                                      a["chroma_slab"], a["dc_slab"],
                                      packed.ls4, packed.ls8)]
    tp = packed_from_numpy(packed, device="cpu")
    recon = tfused.make_reconstruct_fused_slots2(
        packed.wmb, packed.hmb, packed.batch, has8x8=False, haspcm=False)
    got = recon(*(tp.arrays[k] for k in ("meta_slab", "luma_slab",
                                         "chroma_slab", "dc_slab")),
                tp.ls4, tp.ls8)
    assert_planes_equal(want, got, "specialised")


def test_port_staging_matches_jax():
    """The port's own staging + native parse equals the JAX package's:
    its MB-major records, laid out into the kernel's feeds on their
    device (the plain gather on the CPU), are the JAX package's device
    layout."""
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops.recon import (make_slab_staging2,
                                               pack_frames_slots2)
    from minivideo_tpu_torch.ops.recon_fused import (DEVICE_STAGING,
                                                     device_feeds)
    data = make_stream(width_mbs=5, height_mbs=4, n_pictures=3, seed=12,
                       mb_kinds=("i16", "i4", "i8"), transform_8x8=True,
                       profile=100, n_slices=2, allow_pcm=True)
    jp, _, _, _ = jax_packed(data)
    (parsed, tp), = stage_annexb(data, "cpu", staging_mode="device")
    assert len(parsed) == 3 and tp.slots == 2
    assert tp.arrays["records"].device.type == "cpu"
    _, sps, pps, _ = parsed[0]
    feeds = device_feeds(tp.arrays, tp.wmb, tp.hmb)
    for k, f in zip(DEVICE_STAGING, feeds):
        assert f.device.type == "cpu"
        np.testing.assert_array_equal(jp.arrays[k], f.numpy(), err_msg=k)
    np.testing.assert_array_equal(jp.ls4, tp.ls4)
    np.testing.assert_array_equal(jp.ls8, tp.ls8)
    assert (jp.has8x8, jp.haspcm) == (tp.has8x8, tp.haspcm)
    staging = make_slab_staging2(5, 4, 2)
    assert pack_frames_slots2(staging, sps, pps).batch == 2


def test_cuda_tensor_never_runs_plain(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper only: the plain loop is
    not reachable from the CUDA dispatch."""
    from minivideo_tpu_torch.ops import recon_fused as tfused
    calls = []
    monkeypatch.setattr(tfused, "wave_kernel_cuda",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(tfused, "reconstruct_plain",
                        lambda *a, **k: calls.append("plain"))

    class FakeCuda:
        is_cuda = True
        shape = (1,)

    recon = tfused.make_reconstruct_fused_slots2(2, 2, 1)
    recon(FakeCuda(), None, None, None, None, None)
    assert calls == ["kernel"]


def test_kernel_wrapper_rejects_cpu_tensors():
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, _, _, _ = jax_packed(make_stream(width_mbs=2, height_mbs=2,
                                             n_pictures=1, seed=1))
    tp = packed_from_numpy(packed, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.wave_kernel_cuda(
            *(tp.arrays[k] for k in ("meta_slab", "luma_slab",
                                     "chroma_slab", "dc_slab")),
            tp.ls4, tp.ls8, tp.wmb, tp.hmb)


def test_entry_points_default_to_cuda():
    """device=None asks for the GPU: packed_from_numpy and
    reconstruct_frames_fused over numpy staging raise without one;
    staging tensors that already lie on a device stay there."""
    import torch
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops import recon_fused as tfused
    data = make_stream(width_mbs=3, height_mbs=2, n_pictures=1, seed=2)
    jp, _, _, _ = jax_packed(data)
    (_, on_card), = stage_annexb(data, "cpu", staging_mode="device")
    tp = dataclasses.replace(on_card, arrays={           # numpy staging
        k: v.numpy() for k, v in on_card.arrays.items()})
    assert isinstance(tp.arrays["records"], np.ndarray)
    if torch.cuda.is_available():
        assert packed_from_numpy(jp).arrays["meta_slab"].is_cuda
        assert tfused.reconstruct_frames_fused(tp)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            packed_from_numpy(jp)
        with pytest.raises(RuntimeError, match="CUDA"):
            tfused.reconstruct_frames_fused(tp)
    on_cpu = packed_from_numpy(jp, device="cpu")
    got = tfused.reconstruct_frames_fused(on_cpu)
    assert all(g.device.type == "cpu" for g in got)


def test_check_waits_raises_on_a_timed_out_wait():
    """The wrapper's timeout check: an error word that the kernel set
    (1, a wait for the row above timed out) raises, zero words pass, and
    words left by check=False launches are checked once, then dropped."""
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    tfused.check_waits(torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="timed out"):
        tfused.check_waits(torch.zeros(1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))
    tfused._unchecked.append(torch.ones(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="timed out"):
        tfused.check_waits()
    tfused.check_waits()

"""GPU cases of the port's bench (minivideo_tpu_torch/bench.py) and of the
wave kernel's timeout path, with tolerance 0:

  * the kernel built with -DMVT_HOLD_ROW (csrc/wave_kernel.cu), which
    holds frame 0's first row past the wait bound, must make check_waits
    raise, for one launch and at the end of a pipelined run whose
    launches all went unchecked; the build as it ships must not;
  * the pinned pipeline (staging ring, copy stream, compute stream,
    pinned planes) at a small size gives the JAX package's pictures
    (PIPE_DIGESTS; tests/test_torch_bench.py holds them to the JAX
    package) for every batch, in both staging layouts;
  * one 1080p batch of 16 of each committed libx264 stream of bench.py's
    workload (testing/streams.BENCH_X264), through the bench's host_batch
    and device staging, gives libavcodec's pinned digests with one
    launch each;
  * the records' layout kernel (csrc/wave_layout_kernel.cu) equals its
    plain gather on bench.py's 1080p CABAC 8x8 stream at B = 16 and
    B = 1, every element of the four feeds (padding lanes included) on
    feeds that held 0x5A bytes before, one launch a batch on the card.

Each test skips without a CUDA card and carries the `cuda` marker.  This
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_gpu_bench.py
"""

import hashlib

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

HOLD_ROW = ("-DMVT_HOLD_ROW",)
# the pipeline's stream (testing.h264enc.make_stream) and the SHA-256 of
# the JAX package's (Y, Cb, Cr) of each of its pictures
PIPE_KW = dict(width_mbs=6, height_mbs=4, n_pictures=3, seed=71,
               profile=100, transform_8x8=True, mb_kinds=("i16", "i4", "i8"),
               allow_pcm=True)
PIPE_DIGESTS = [
    ["603eea25309964dc455f81d513cc173102fdc6f65d48d75f2db14a1cac599fcf",
     "8800c3e9708f0e182815f9927f465ee88bb5bfa2ae2021dc5c3e7f024177a5c4",
     "4a240e1bde0e74f5503f4dc97de27799f888180f98dba9a2dbfb614a94ed1923"],
    ["4a7f083aef549a6abc3b8bb6f310de5247213c6f18d38739355b732889e63f10",
     "1972e1ee79373b0a79e588d1ecaffae3b97aab846a6ac33c2cb67920c26f48be",
     "059e4a16f8d4a36d673210c63a47a4fb6cb3189320bddb192b07451fc8e9e725"],
    ["85ddf695285be55b7e36aff7cb2c7a881dc095b9b6a954bdbc84fde68e2228ac",
     "5d1df7a338a220e1814431c9f9892cba3eda623ba9d18692aebdea23143b9592",
     "6473709e3ce002394a6f122e1afc1e4975cf42adbe3488f1bd27b9b9bea5c411"],
]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _staged(cuda):
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops.recon_fused import device_feeds
    from minivideo_tpu_torch.testing.h264enc import make_stream
    (_, packed), = stage_annexb(make_stream(**PIPE_KW), cuda,
                                staging_mode="device")
    return packed, device_feeds(packed.arrays, packed.wmb, packed.hmb)


def test_hold_row_build_times_out_one_launch(cuda):
    from minivideo_tpu_torch.ops import kernels, recon_fused as rf
    packed, arrs = _staged(cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb,
            packed.has8x8, packed.haspcm)
    *_, word = rf._wave_launch(lambda: kernels.load(HOLD_ROW), *args)
    with pytest.raises(RuntimeError, match="timed out"):
        rf.check_waits(word)
    *_, word = rf._wave_launch(kernels.load, *args)
    rf.check_waits(word)


def _bench(cuda, batch, iters):
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.testing.h264enc import make_stream
    b = bench.Bench(cuda, PIPE_KW["width_mbs"], PIPE_KW["height_mbs"],
                    batch, iters, 1)
    return b, bench.prep_pictures(make_stream(**PIPE_KW))


def test_hold_row_build_times_out_pipelined_run(cuda, monkeypatch):
    """Every launch of a pipelined run is unchecked until check_waits()."""
    from minivideo_tpu_torch.ops import kernels
    load = kernels.load
    monkeypatch.setattr(kernels, "load", lambda defines=(): load(HOLD_ROW))
    b, prep = _bench(cuda, 2, 2)
    try:
        b.overlapped(prep)
        with pytest.raises(RuntimeError, match="timed out"):
            b.check_waits()
    finally:
        b.close()


@pytest.mark.parametrize("mode", ["device", "records"])
def test_pinned_pipeline_gives_jax_pictures(cuda, monkeypatch, mode):
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", mode)
    from minivideo_tpu_torch.ops import recon_fused as rf
    from minivideo_tpu_torch.ops.wave_layout import wave_layout_cuda
    batch, iters = 4, 5
    b, prep = _bench(cuda, batch, iters)
    got = []
    try:
        assert b.mode == mode and all(
            t.is_pinned() for t in b.ring.slots[0].host.values())
        rf.wave_kernel_cuda.launches = 0
        wave_layout_cuda.launches_by_device = {}
        b.overlapped(prep, lambda i, planes: got.append(
            [[_sha(p[r]) for p in planes] for r in range(batch)]))
        b.check_waits()
        assert rf.wave_kernel_cuda.launches == iters
        assert wave_layout_cuda.launches_by_device == (
            {cuda.index or 0: iters} if mode == "device" else {})
    finally:
        b.close()
    n = len(PIPE_DIGESTS)
    for i, batch_digests in enumerate(got):
        assert batch_digests == [PIPE_DIGESTS[r % n] for r in range(batch)], i
    assert len(got) == iters


def test_committed_x264_streams_give_libavcodec_pictures(cuda):
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.ops import recon_fused as rf
    from minivideo_tpu_torch.testing import streams as st
    b = bench.Bench(cuda, 120, 68, bench.BATCH, 1, 1)
    try:
        for name, (_, _, _, digests) in st.BENCH_X264.items():
            prep = bench.prep_pictures(st.bench_x264(name))
            fn = b.bind(bench.host_batch(*prep, b.pool, "device", b.batch))
            rf.wave_kernel_cuda.launches = 0
            planes = [p.cpu().numpy() for p in fn()]
            b.check_waits()
            assert rf.wave_kernel_cuda.launches == 1, name
            bench.lavc_check([[p[r] for p in planes]
                              for r in range(b.batch)], digests, name)
    finally:
        b.close()


@pytest.mark.parametrize("batch", [16, 1])
def test_layout_kernel_equals_plain_gather(cuda, batch):
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.ops import wave_layout as wl
    from minivideo_tpu_torch.testing import streams as st
    prep = bench.prep_pictures(st.bench_x264("cabac_8x8"))
    with ThreadPoolExecutor(max_workers=8) as pool:
        pk = bench.host_batch(*prep, pool, "device", batch)
    recs = torch.from_numpy(pk.arrays["records"]).to(cuda)
    out = wl.empty_feeds(pk.wmb, pk.hmb, batch, cuda)
    for t in out:
        t.view(torch.uint8).fill_(0x5A)
    wl.wave_layout_cuda.launches_by_device = {}
    got = wl.wave_layout_cuda(recs, pk.wmb, pk.hmb, out=out)
    assert wl.wave_layout_cuda.launches_by_device == {cuda.index or 0: 1}
    want = wl.wave_layout_plain(recs, pk.wmb, pk.hmb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert torch.equal(got[0], wl.wave_layout_cuda(recs, pk.wmb,
                                                    pk.hmb)[0])

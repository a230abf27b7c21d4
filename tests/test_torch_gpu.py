"""GPU cases of the port: the CUDA kernels against their plain PyTorch
versions on the card, with tolerance 0.  Each test skips without a CUDA
card (the kernels have no CPU mode) and carries the `cuda` marker
registered in pyproject.toml.  This file imports neither JAX nor
the JAX package, so it runs on the GPU host, where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py

torch and the port are imported by the `cuda` fixture, not at collection
(see torch_port_helpers.py).
"""

import os

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
    # shapes that stress the flags between MB rows
    "one_col": dict(width_mbs=1, height_mbs=12, n_pictures=2, seed=45,
                    mb_kinds=("i16", "i4")),
    "one_row": dict(width_mbs=12, height_mbs=1, n_pictures=2, seed=46,
                    mb_kinds=("i16", "i4")),
    # every MB at a right edge: the wait target min(c + 2, wmb)
    "right_edges": dict(width_mbs=2, height_mbs=9, n_pictures=2, seed=47,
                        profile=100, transform_8x8=True,
                        mb_kinds=("i16", "i4", "i8")),
    "strip_slices": dict(width_mbs=120, height_mbs=3, n_pictures=2,
                         seed=48, profile=100, transform_8x8=True,
                         mb_kinds=("i16", "i4", "i8"), n_slices=3,
                         allow_pcm=True),
    # B * hmb = 4,800 rows, more than 132 SMs x 32 blocks can hold: the
    # row tickets must not deadlock
    "resident": dict(width_mbs=8, height_mbs=4, n_pictures=2, seed=49,
                     mb_kinds=("i16", "i4")),
}
# access units of a stream repeated to a larger batch
REPEAT = {"resident": 600}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(name):
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import repeat_pictures
    data = make_stream(**STREAMS[name])
    return repeat_pictures(data, REPEAT[name]) if name in REPEAT else data


def _staging(data, device):
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops.recon_fused import device_feeds
    (_, packed), = stage_annexb(data, device, staging_mode="device")
    return packed, device_feeds(packed.arrays, packed.wmb, packed.hmb)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_kernel_matches_plain(name, cuda):
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, arrs = _staging(_stream(name), cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    got = tfused.wave_kernel_cuda(*args, **kw)
    want = tfused.reconstruct_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == w.shape
        assert torch.equal(g, w)


def test_kernel_repeats_identical(cuda):
    """20 launches on one input give identical planes: a race between
    the rows' flags and their pixels would show as a difference."""
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, arrs = _staging(_stream("strip_slices"), cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    first = tfused.wave_kernel_cuda(*args, **kw)
    for _ in range(20):
        got = tfused.wave_kernel_cuda(*args, **kw)
        assert all(torch.equal(g, f) for g, f in zip(got, first))


def test_decode_on_card_counts_launches(cuda):
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.ops import recon_fused as tfused
    data = _stream("i8_slices")
    tfused.wave_kernel_cuda.launches = 0
    got = tdec.decode_annexb(data)
    assert tfused.wave_kernel_cuda.launches == 1      # one per batch
    want = tdec.decode_annexb(data, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in ((g.y, w.y), (g.cb, w.cb), (g.cr, w.cr)):
            assert (a == b).all()


def test_wrapper_rejects_bad_tensors(cuda):
    import torch
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, arrs = _staging(_stream("kinds_pcm"), cuda)
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


def test_interleave_matches_plain_and_library(cuda):
    import torch
    from minivideo_tpu_torch.ops import interleave
    gen = torch.Generator(device=cuda).manual_seed(5)
    for B, wmb, hmb in ((3, 7, 5), (2, 120, 68), (1, 1, 1)):
        tiles = torch.randint(0, 256, (B, wmb * hmb, 256), generator=gen,
                              device=cuda, dtype=torch.uint8)
        interleave.tiles_to_raster_cuda.launches = 0
        got = interleave.tiles_to_raster_cuda(tiles, wmb, hmb)
        assert interleave.tiles_to_raster_cuda.launches == 1
        want = interleave.tiles_to_raster_plain(tiles, wmb, hmb)
        lib = tiles.view(B, hmb, wmb, 16, 16).permute(
            0, 1, 3, 2, 4).contiguous().view(B, 16 * hmb, 16 * wmb)
        assert got.shape == (B, 16 * hmb, 16 * wmb)
        assert torch.equal(got, want) and torch.equal(got, lib)
    strided = torch.zeros((2, 35, 512), dtype=torch.uint8,
                          device=cuda)[:, :, :256]
    with pytest.raises(ValueError):
        interleave.tiles_to_raster_cuda(strided, 7, 5)
    with pytest.raises(TypeError):
        interleave.tiles_to_raster_cuda(strided.int(), 7, 5)


def test_mv_decode_mp4_on_card_equals_cpu(cuda, tmp_path):
    """mv_open / mv_parse / mv_decode of a small MP4 on the card, with
    RGB: one launch, and the CPU run's planes and RGB."""
    from minivideo_tpu_torch import api
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.testing.containers import write_mp4
    path = tmp_path / "clip.mp4"
    path.write_bytes(write_mp4(_stream("i8_slices"), 112, 80))
    media = api.mv_open(str(path))
    assert api.mv_parse(media, audio=False, subs=False)
    tfused.wave_kernel_cuda.launches = 0
    got = api.mv_decode(media, picture_number=3, want_rgb=True)
    assert tfused.wave_kernel_cuda.launches == 1
    want = api.mv_decode(media, picture_number=3, device="cpu",
                         want_rgb=True)
    api.mv_close(media)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in ((g.y, w.y), (g.cb, w.cb), (g.cr, w.cr), (g.rgb, w.rgb)):
            assert a.shape == b.shape and (a == b).all()


def _same_tree(a, b):
    names = sorted(f for f in os.listdir(b) if not f.endswith(".jsonl"))
    assert names and sorted(f for f in os.listdir(a)
                            if not f.endswith(".jsonl")) == names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_batch_thumbnail_on_card_equals_cpu(cuda, tmp_path):
    """batch_thumbnail over three buckets ((7x5 MBs, 8x8 transform),
    (7x5, 4x4 only) and (4x3)) and a clip whose slice data is spoiled:
    one launch per bucket, the corrupt clip failed, and the CPU run's
    files, for a planar and an RGB format."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.parallel import batch_thumbnail
    from minivideo_tpu_torch.testing.containers import write_mp4, write_ts
    from minivideo_tpu_torch.testing.h264enc import make_stream
    (tmp_path / "a.mp4").write_bytes(write_mp4(_stream("i8_slices"), 112,
                                               80))
    (tmp_path / "b.ts").write_bytes(write_ts(_stream("kinds_pcm")))
    small = dict(width_mbs=4, height_mbs=3, n_pictures=2, seed=50)
    (tmp_path / "c.264").write_bytes(make_stream(**small))
    bad = bytearray(make_stream(**dict(small, seed=51)))
    for pos in range(len(bad) * 2 // 3, len(bad) - 8, 3):
        bad[pos] ^= 0xFF
    (tmp_path / "d.264").write_bytes(bytes(bad))
    clips = sorted(str(p) for p in tmp_path.iterdir())
    for fmt in (PictureFormat.YUV420, PictureFormat.PNG):
        out = {}
        for dev in (None, "cpu"):
            tag = f"{fmt.name}_{dev}"
            tfused.wave_kernel_cuda.launches = 0
            res = batch_thumbnail(clips, str(tmp_path / tag), device=dev,
                                  fmt=fmt, pictures_per_clip=2)
            out[dev] = (str(tmp_path / tag), tfused.wave_kernel_cuda.launches)
            assert (res.done, res.failed) == (3, 1)
            assert [os.path.basename(p) for p in res.errors] == ["d.264"]
        assert out[None][1] == 3 and out["cpu"][1] == 0
        _same_tree(out[None][0], out["cpu"][0])


def test_thumbnailer_on_card_equals_cpu(cuda, tmp_path):
    """The thumbnailer CLI on the card (the default device) and with
    --device cpu write the same files; one launch per call."""
    from minivideo_tpu_torch.apps.thumbnailer import main
    from minivideo_tpu_torch.ops import recon_fused as tfused
    from minivideo_tpu_torch.testing.containers import write_mkv
    path = tmp_path / "clip.mkv"
    path.write_bytes(write_mkv(_stream("qp51"), 80, 96))
    for fmt in ("png", "jpg", "yuv420"):
        args = ["-i", str(path), "-f", fmt, "-n", "2"]
        tfused.wave_kernel_cuda.launches = 0
        assert main(args + ["-o", str(tmp_path / f"{fmt}_card")]) == 0
        assert tfused.wave_kernel_cuda.launches == 1
        assert main(args + ["-o", str(tmp_path / f"{fmt}_cpu"),
                            "--device", "cpu"]) == 0
        _same_tree(str(tmp_path / f"{fmt}_card"), str(tmp_path / f"{fmt}_cpu"))


def test_device_trace_records_the_kernel(cuda, tmp_path):
    """profiling.device_trace on the card: the Chrome trace it writes
    holds the wave kernel's launch as a device event."""
    import json
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.profiling import device_trace
    data = _stream("kinds_pcm")
    tdec.decode_annexb(data)                 # build and warm up first
    with device_trace(str(tmp_path)):
        tdec.decode_annexb(data)
    trace, = tmp_path.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    # the kernel is launched through ctypes, not torch: only the device
    # event carries its name
    assert any("wave_kernel" in e.get("name", "") for e in events)

"""GPU cases of the port's scale-out layer (parallel/sharding.py, halo.py,
multihost.py) on the card, with tolerance 0: batch_thumbnail over a mesh
whose entries all name the card launches wave_kernel.cu once per entry
and bucket and writes the one-device run's files; the halo over strips
of the card gives the fused kernel's planes; two multihost workers share
the card.  Over several cards (these skip with fewer than 2): the
default mesh of every card writes the one-card run's files with each
card launching once per bucket, the halo over 2 cards gives the fused
kernel's planes, and 2 ranks of one card each run over nccl.  Each test
skips without a CUDA card and carries the `cuda` marker.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_gpu_scaleout.py

torch and the port are imported by the `cuda` fixture and the tests,
not at collection (see torch_port_helpers.py).
"""

import os

import pytest

pytestmark = pytest.mark.cuda

KW = dict(n_pictures=2, mb_kinds=("i16", "i4"), density=0.4,
          allow_pcm=True)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def cards(cuda):
    """cuda:0..n-1, where n >= 2."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 CUDA cards, {n} present")
    return [torch.device(f"cuda:{k}") for k in range(n)]


def _clips(tmp_path):
    """Two buckets: three 5x4-MB clips and one 4x3-MB clip."""
    from minivideo_tpu_torch.testing.h264enc import make_stream
    clips = []
    for i, (w, h) in enumerate([(5, 4), (5, 4), (5, 4), (4, 3)]):
        clips.append(str(tmp_path / f"c{i}.264"))
        with open(clips[-1], "wb") as f:
            f.write(make_stream(width_mbs=w, height_mbs=h, seed=90 + i,
                                **KW))
    return clips


def _files(outdir):
    out = {}
    for n in sorted(os.listdir(outdir)):
        if not n.endswith(".jsonl"):
            with open(os.path.join(outdir, n), "rb") as f:
                out[n] = f.read()
    return out


def test_mesh_batch_thumbnail_on_card(cuda, tmp_path):
    """Two buckets (5x4 and 4x3 MBs) over a 2x2 mesh of the card: 8
    launches, and the files of the one-device run (1 launch a bucket)."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel import batch_thumbnail, make_mesh
    clips = _clips(tmp_path)
    launches = {}
    for name, kw in (("mesh", dict(mesh=make_mesh(devices=[cuda] * 4))),
                     ("one", dict(device=cuda))):
        recon_fused.wave_kernel_cuda.launches = 0
        res = batch_thumbnail(clips, str(tmp_path / name),
                              pictures_per_clip=2,
                              fmt=PictureFormat.YUV420, **kw)
        launches[name] = recon_fused.wave_kernel_cuda.launches
        assert (res.done, res.failed, res.frames) == (4, 0, 8)
    assert launches == {"mesh": 8, "one": 2}
    assert _files(str(tmp_path / "mesh")) == _files(str(tmp_path / "one"))


@pytest.mark.parametrize("n", [2, 4])
def test_halo_on_card_equals_fused(cuda, n):
    """6x5 MBs x2 (8 lanes) over n strips of the card: the fused
    kernel's planes, with no kernel launch."""
    import numpy as np
    import torch
    from minivideo_tpu_torch.models.h264.decoder import (decode_annexb,
                                                         stage_annexb)
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel.halo import reconstruct_frames_halo
    from minivideo_tpu_torch.parallel.sharding import Mesh
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(width_mbs=6, height_mbs=5, seed=60, **KW)
    (_, packed), = stage_annexb(data, cuda)
    devs = np.empty(n, dtype=object)
    devs[:] = [cuda] * n
    recon_fused.wave_kernel_cuda.launches = 0
    got = reconstruct_frames_halo(packed, Mesh(devs, ("lanes",)))
    assert recon_fused.wave_kernel_cuda.launches == 0
    assert all(p.is_cuda for p in got)
    for i, pic in enumerate(decode_annexb(data)):
        for a, b in zip(got, (pic.y, pic.cb, pic.cr)):
            assert torch.equal(a[i].cpu(), torch.as_tensor(b))


def test_multihost_on_card(cuda):
    """Two workers of 2 mesh entries each (sharing the card over gloo on
    one card; nccl where their hub cards differ): phase A 2 launches per process, the count
    reduce 4, phase B's halo across both processes bit-exact."""
    from minivideo_tpu_torch.parallel.multihost import (placement,
                                                        run_multihost_dryrun)
    out = run_multihost_dryrun(nprocs=2, devices_per_proc=2, timeout=300)
    _, backend = placement(0, 2, 2)
    assert out.count(f"backend {backend}") == 2
    assert out.count("wave_kernel launches 2") == 2
    assert out.count("reduce across processes = 4") == 2
    assert out.count("phase B OK") == 2 and out.count("MULTIHOST OK") == 2


def test_default_mesh_over_cards_equals_one_card(cards, tmp_path):
    """batch_thumbnail with no mesh and no device runs over every card:
    each card launches once per bucket (2), and the files are those of
    the run on cuda:0 alone."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel import batch_thumbnail
    clips = _clips(tmp_path)
    launches = {}
    for name, kw in (("cards", {}), ("one", dict(device=cards[0]))):
        recon_fused.wave_kernel_cuda.launches_by_device = {}
        res = batch_thumbnail(clips, str(tmp_path / name),
                              pictures_per_clip=2,
                              fmt=PictureFormat.YUV420, **kw)
        launches[name] = recon_fused.wave_kernel_cuda.launches_by_device
        assert (res.done, res.failed, res.frames) == (4, 0, 8)
    assert launches == {"cards": {k: 2 for k in range(len(cards))},
                        "one": {0: 2}}
    assert _files(str(tmp_path / "cards")) == _files(str(tmp_path / "one"))


def test_halo_over_two_cards_equals_fused(cards):
    """6x5 MBs x2 (8 lanes) over one strip on each of 2 cards: the fused
    kernel's planes on the first card, with no kernel launch."""
    import numpy as np
    import torch
    from minivideo_tpu_torch.models.h264.decoder import (decode_annexb,
                                                         stage_annexb)
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel.halo import reconstruct_frames_halo
    from minivideo_tpu_torch.parallel.sharding import Mesh
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(width_mbs=6, height_mbs=5, seed=60, **KW)
    (_, packed), = stage_annexb(data, cards[1])
    devs = np.empty(2, dtype=object)
    devs[:] = cards[:2]
    recon_fused.wave_kernel_cuda.launches = 0
    got = reconstruct_frames_halo(packed, Mesh(devs, ("lanes",)))
    assert recon_fused.wave_kernel_cuda.launches == 0
    assert all(p.device == cards[0] for p in got)
    for i, pic in enumerate(decode_annexb(data, device=cards[1])):
        for a, b in zip(got, (pic.y, pic.cb, pic.cr)):
            assert torch.equal(a[i].cpu(), torch.as_tensor(b))


def test_multihost_two_ranks_over_nccl(cards):
    """Two workers of one card each: nccl, hubs cuda:0 and cuda:1, phase
    A's launch on each worker's own card, phase B's halo across both."""
    from minivideo_tpu_torch.parallel.multihost import run_multihost_dryrun
    out = run_multihost_dryrun(nprocs=2, devices_per_proc=1, timeout=300)
    assert out.count("backend nccl") == 2
    assert "(hub cuda:0)" in out and "(hub cuda:1)" in out
    assert "wave_kernel launches 1 by card {0: 1}" in out
    assert "wave_kernel launches 1 by card {1: 1}" in out
    assert out.count("phase B OK") == 2 and out.count("MULTIHOST OK") == 2

"""GPU cases of the port's scale-out layer (parallel/sharding.py, halo.py,
multihost.py) on the card, with tolerance 0: batch_thumbnail over a mesh
whose entries all name the card launches wave_kernel.cu once per entry
and bucket and writes the one-device run's files; the halo over strips
of the card gives the fused kernel's planes; two multihost workers share
the card.  Each test skips without a CUDA card and carries the `cuda`
marker.  This file imports neither JAX nor the JAX package:

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
    from minivideo_tpu_torch.testing.h264enc import make_stream
    clips = []
    for i, (w, h) in enumerate([(5, 4), (5, 4), (5, 4), (4, 3)]):
        clips.append(str(tmp_path / f"c{i}.264"))
        with open(clips[-1], "wb") as f:
            f.write(make_stream(width_mbs=w, height_mbs=h, seed=90 + i,
                                **KW))
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
    """Two workers sharing the card (gloo; nccl where each has its own),
    2 mesh entries each: phase A 2 launches per process, the count
    reduce 4, phase B's halo across both processes bit-exact."""
    import torch
    from minivideo_tpu_torch.parallel.multihost import run_multihost_dryrun
    out = run_multihost_dryrun(nprocs=2, devices_per_proc=2, timeout=300)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert out.count(f"backend {backend}") == 2
    assert out.count("wave_kernel launches 2") == 2
    assert out.count("reduce across processes = 4") == 2
    assert out.count("phase B OK") == 2 and out.count("MULTIHOST OK") == 2

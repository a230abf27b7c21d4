"""The port's multi-process run (minivideo_tpu_torch/parallel/multihost.py)
on the CPU: torch.distributed workers over gloo, each owning two CPU mesh
entries.  Phase A reconstructs each process's own clips over its local
mesh, an all_reduce sums the frame counts, and phase B splits one batch's
lane axis over the strips of both processes with one all_reduce of the
edge buffer per wave.  The workers check their pictures against the
port's numpy oracle; here the planes they save are held against the JAX
package's reconstruct_frame on the same clips (tolerance 0).  The port's
_partition loses no clip, where the JAX package's drops the remainder.
(The port is imported inside the tests: see torch_port_helpers.py.)"""

import os
import time

import numpy as np
import pytest


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """(output, out_dir) of 2 gloo workers x 2 CPU mesh entries."""
    from minivideo_tpu_torch.parallel.multihost import run_multihost_dryrun
    out_dir = str(tmp_path_factory.mktemp("mh"))
    out = run_multihost_dryrun(nprocs=2, devices_per_proc=2, timeout=300,
                               device="cpu", out_dir=out_dir)
    return out, out_dir


def test_two_process_markers(two_process_run):
    out, _ = two_process_run
    assert out.count("MULTIHOST OK") == 2
    assert out.count("phase A OK") == 2
    assert out.count("phase B OK") == 2
    assert out.count("backend gloo") == 2
    assert out.count("all_reduce frame-count reduce across processes "
                     "= 4") == 2
    assert out.count("wave_kernel launches 0") == 2      # the CPU's loop
    assert out.count("12 per-wave edge all_reduces") == 2   # 12 waves


def test_planes_equal_jax_reconstruct_frame(two_process_run):
    """Phase A's planes (each process's own clips) and phase B's (both
    processes' strips, the batch of clips 0 and 1) equal the JAX
    package's oracle on its fixture encoder's clips."""
    from minivideo_tpu.models.h264.recon_np import reconstruct_frame
    from minivideo_tpu.parallel.multihost import (_clip_streams,
                                                  _parse_clip_syntax)
    _, out_dir = two_process_run
    want = [reconstruct_frame(*_parse_clip_syntax(c))
            for c in _clip_streams(4)]
    owned = []
    for pid in range(2):
        z = np.load(os.path.join(out_dir, f"mh_planes.{pid}.npz"))
        owned += list(z["a_clips"])
        for j, ci in enumerate(z["a_clips"]):
            for k, name in enumerate(("y", "cb", "cr")):
                np.testing.assert_array_equal(z[f"a_{name}"][j],
                                              want[ci][k])
        assert z["b_y"].shape[0] == 2
        for i in range(2):
            for k, name in enumerate(("y", "cb", "cr")):
                np.testing.assert_array_equal(z[f"b_{name}"][i],
                                              want[i][k])
    assert sorted(owned) == [0, 1, 2, 3]


@pytest.mark.parametrize("n_clips,nprocs", [(7, 2), (7, 3), (8, 2),
                                            (2, 3)])
def test_partition_covers_every_clip_once(n_clips, nprocs):
    """Contiguous shards, sizes differing by at most one."""
    from minivideo_tpu_torch.parallel.multihost import _partition
    parts = [_partition(n_clips, p, nprocs) for p in range(nprocs)]
    assert sum(parts, []) == list(range(n_clips))
    assert max(map(len, parts)) - min(map(len, parts)) <= 1


def test_jax_partition_drops_the_remainder():
    """The known fault that the port's copy fixes: the JAX package's
    _partition loses n_clips % nprocs clips."""
    from minivideo_tpu.parallel.multihost import _partition
    assert sorted(_partition(7, 0, 2) + _partition(7, 1, 2)) == \
        list(range(6))


def test_three_processes_seven_clips_from_files(tmp_path):
    """Clips read from files (a shared filesystem's stand-in), 7 over 3
    processes of one CPU entry each: every clip is owned and written to
    a manifest exactly once, and the count reduce is 7."""
    from minivideo_tpu_torch.parallel.multihost import (_clip_streams,
                                                        run_multihost_dryrun)
    files = []
    for i, data in enumerate(_clip_streams(7)):
        files.append(str(tmp_path / f"clip{i}.264"))
        with open(files[-1], "wb") as f:
            f.write(data)
    out = run_multihost_dryrun(nprocs=3, devices_per_proc=1, timeout=300,
                               device="cpu", clip_files=files,
                               out_dir=str(tmp_path))
    assert out.count("MULTIHOST OK") == 3
    assert out.count("reduce across processes = 7") == 3
    assert "clips [0, 1, 2] of 7" in out and "clips [5, 6] of 7" in out
    done = []
    for pid in range(3):
        with open(tmp_path / f"mh_manifest.{pid}.jsonl") as f:
            done += [line.split('"clip": "')[1].split('"')[0] for line in f]
    assert sorted(done) == sorted(f"clip{i}" for i in range(7))


def test_process_group_timeout(monkeypatch):
    """The workers' process group gets a timeout of at most 120 s, so a
    dead peer fails the run instead of hanging it."""
    import torch.distributed as dist
    from minivideo_tpu_torch.parallel import multihost
    seen = {}

    class Stop(Exception):
        pass

    def init(backend, **kw):
        seen.update(kw, backend=backend)
        raise Stop                    # before any collective

    monkeypatch.setattr(dist, "init_process_group", init)
    with pytest.raises(Stop):
        multihost.worker(0, 2, "tcp://localhost:1", 2, device="cpu")
    assert seen["backend"] == "gloo"
    assert 0 < seen["timeout"].total_seconds() == multihost.PG_TIMEOUT_S
    assert multihost.PG_TIMEOUT_S <= 120


def test_failed_worker_stops_the_run(tmp_path):
    """A worker that fails makes the launcher stop the rest and raise,
    long before the process group's timeout."""
    from minivideo_tpu_torch.parallel.multihost import (PG_TIMEOUT_S,
                                                        run_multihost_dryrun)
    t = time.time()
    with pytest.raises(RuntimeError, match="worker 0 failed"):
        run_multihost_dryrun(nprocs=2, devices_per_proc=1, timeout=300,
                             device="cpu",
                             clip_files=[str(tmp_path / "missing.264")])
    assert time.time() - t < PG_TIMEOUT_S


@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_placement_is_the_jax_reshape_order(count, monkeypatch):
    """Process p's mesh entries are the cards of row p of the JAX
    worker's Mesh(np.array(jax.devices()).reshape(nprocs, dpp)), modulo
    the card count, its hub the first; nccl only where no two processes'
    hubs are one card (NCCL refuses two ranks on one GPU), gloo else and
    for a named device.  (Cards are faked: a torch.device names a card
    without touching it.)"""
    import jax
    import torch
    from minivideo_tpu_torch.parallel.multihost import placement
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for nprocs in (1, 2, 4, 8):
        for dpp in (1, 2, 4):
            if nprocs * dpp > len(jax.devices()):
                continue
            order = np.array(jax.devices()[:nprocs * dpp]).reshape(
                nprocs, dpp)
            got = [placement(p, nprocs, dpp) for p in range(nprocs)]
            hubs = [devs[0] for devs, _ in got]
            for p, (devs, backend) in enumerate(got):
                assert [str(d) for d in devs] == \
                    [f"cuda:{d.id % count}" for d in order[p]]
                assert backend == ("nccl" if len(set(hubs)) == nprocs
                                   else "gloo"), (nprocs, dpp)
    devs, backend = placement(1, 2, 2, device="cpu")
    assert [str(d) for d in devs] == ["cpu", "cpu"] and backend == "gloo"

"""Multi-process execution: torch.distributed workers.

Port of minivideo_tpu/parallel/multihost.py.  N worker processes join one
process group; each owns `--devices` mesh entries (`placement`): by
default process p takes cards p*K .. p*K + K - 1 (modulo the card count),
the JAX module's reshape(nprocs, K) of the global devices, its hub (the
first) for the process group; a named device (the CPU) holds every entry:

  * phase A (data parallel over clips): each process entropy-decodes ITS
    OWN partition of the clip set host-locally, writes its per-process
    Manifest, reconstructs its shard over its local mesh with the batch
    pipeline's _Recon (engine "fused": one wave_kernel launch per local
    mesh entry on the card) and checks each picture against the numpy
    oracle (recon_np.reconstruct_frame);
  * the per-process frame counts are reduced with one all_reduce (the
    metrics reduction; JAX's cross-process psum);
  * phase B (the halo across the process boundary): the fused lane axis
    of one replicated batch is split over every mesh entry of every
    process, and halo.halo_loop's per-wave edge exchange is one
    all_reduce(SUM) of the [strips + 2, EDGE_LANES] edge buffer in which
    each process fills its own strips' rows.  The strips' planes are
    gathered the same way, and every process checks every picture.

Backend: "nccl" where no two ranks' hubs are one card, "gloo" on the CPU
and where hubs share a card (NCCL refuses two ranks on one GPU).  Gloo
takes CUDA tensors for all_reduce and broadcast only, hence all_reduce
for every exchange: one code path for nccl, gloo on the CPU and gloo on
the card.

The clips are the port's own make_stream2 streams (6x4 MBs, CAVLC and
CABAC alternating), or files the launcher is given (`clip_files`), as a
deployment reads its clips from a shared filesystem.  The partition is
contiguous and loses no clip: the first n_clips % nprocs processes take
one clip more (the JAX module's drops the remainder).

Launch: run_multihost_dryrun() starts the workers on a free-port tcp://
store, with a PG_TIMEOUT_S timeout on the process group so that a dead
peer fails the run instead of hanging it.  Worker entry: python -m
minivideo_tpu_torch.parallel.multihost --pid I --procs N --init-method
tcp://localhost:P [--devices K] [--device cpu] [--clips F ...] [--out D].
"""

from __future__ import annotations

import argparse
import hashlib
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

WMB, HMB = 6, 4                  # tiny geometry: the oracle stays seconds
PG_TIMEOUT_S = 60                # a dead peer fails the run after this
MODULE = "minivideo_tpu_torch.parallel.multihost"


# ---------------------------------------------------------------------------
# clip set: deterministic and shared by every process; the partition
# assigns ownership

def _clip_streams(n_clips: int):
    """n_clips tiny Annex-B streams (mixed CAVLC/CABAC), deterministic."""
    from ..testing.h264enc2 import make_stream2
    return [make_stream2(width_mbs=WMB, height_mbs=HMB, n_pictures=1,
                         seed=100 + i, mb_kinds=("i16", "i4"),
                         density=0.35,
                         entropy="cabac" if i % 2 else "cavlc",
                         allow_pcm=False)
            for i in range(n_clips)]


def _partition(n_clips: int, pid: int, nprocs: int):
    """Contiguous clip shard for process `pid` (manifest files are per
    process): every clip is owned exactly once, the first
    n_clips % nprocs processes taking one more."""
    per, extra = divmod(n_clips, nprocs)
    lo = pid * per + min(pid, extra)
    return list(range(lo, lo + per + (pid < extra)))


def _parse_clip_syntax(data: bytes):
    """(FrameSyntax, SPS, PPS, slice_of_mb) of the clip's first IDR
    picture, parsed on the host."""
    from ..models.h264.decoder import H264Decoder, group_idr_access_units
    from ..models.h264.nalu import parse_nalu, split_annexb
    dec = H264Decoder(device="cpu")      # parses only: no device work
    nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
    for n in nalus:
        if n.nal_unit_type in (7, 8):
            dec.feed_nalu(n)
    group = group_idr_access_units(nalus)[0]
    return dec.parse_idr_syntax(group)


def placement(pid: int, nprocs: int, devices_per_proc: int, device=None):
    """(devices, backend) of process `pid`: its mesh entries, the first
    its hub (the process group's and phase B's gather device), and the
    process group's backend.  Without a named device, entry k is card
    (pid * devices_per_proc + k) modulo the card count (no card raises),
    and the backend is nccl where no two processes' hubs coincide, else
    gloo.  A named device holds every entry, over gloo."""
    import torch
    if device is not None:
        return [torch.device(device)] * devices_per_proc, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device "
                           "cpu to run on the CPU")
    count = torch.cuda.device_count()
    first = pid * devices_per_proc
    devices = [torch.device(f"cuda:{(first + k) % count}")
               for k in range(devices_per_proc)]
    hubs = {p * devices_per_proc % count for p in range(nprocs)}
    return devices, "nccl" if len(hubs) == nprocs else "gloo"


def _check(planes, want, what):
    for name, a, b in zip(("Y", "Cb", "Cr"), planes, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# worker

def worker(pid: int, nprocs: int, init_method: str, devices_per_proc: int,
           device=None, clip_files=None, out_dir=None) -> None:
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    devices, backend = placement(pid, nprocs, devices_per_proc, device)
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])     # before nccl's communicator
    t = time.time()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nprocs, rank=pid,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        _phases(pid, nprocs, devices, backend, clip_files, out_dir,
                time.time() - t)
    finally:
        dist.destroy_process_group()


def _phases(pid, nprocs, devices, backend, clip_files, out_dir, init_s):
    import torch
    import torch.distributed as dist
    from ..models.h264.recon_np import reconstruct_frame
    from ..ops import recon_fused
    from ..ops.recon import pack_frames
    from ..ops.recon_wave import skew_tables
    from .batch import _Recon
    from .halo import halo_loop, lane_feeds
    from .manifest import Manifest
    from .sharding import make_mesh

    devices_per_proc, dev = len(devices), devices[0]
    n_dev = nprocs * devices_per_proc
    print(f"mh[{pid}]: {nprocs} processes x {devices_per_proc} mesh "
          f"entries on {', '.join(map(str, devices))} (hub {dev}), "
          f"{n_dev} global, backend {backend} (init {init_s:.2f}s)",
          flush=True)

    if clip_files:
        clips = []
        for path in clip_files:
            with open(path, "rb") as f:
                clips.append(f.read())
    else:
        clips = _clip_streams(n_dev)      # one frame per mesh entry
    n_clips = len(clips)
    syntax, oracle = {}, {}

    def parse(ci):
        """Clip ci's picture syntax, parsed once per process."""
        if ci not in syntax:
            syntax[ci] = _parse_clip_syntax(clips[ci])
        return syntax[ci]

    def want(ci):
        """The oracle's planes of clip ci, once per distinct clip."""
        key = hashlib.sha256(clips[ci]).digest()
        if key not in oracle:
            oracle[key] = reconstruct_frame(*parse(ci))
        return oracle[key]

    # ---- phase A: data parallel, each process parses ITS shard ---------
    t = time.time()
    mine = _partition(n_clips, pid, nprocs)
    mdir = out_dir or tempfile.mkdtemp(prefix="mvt_multihost_")
    man = Manifest(os.path.join(mdir, f"mh_manifest.{pid}.jsonl"))
    parsed = []
    for ci in mine:
        parsed.append(parse(ci))
        man.done(f"clip{ci}")
    man.close()
    planes_a = [np.zeros((0,), np.uint8)] * 3
    launches, by_card = 0, {}
    if mine:
        _, sps, pps, _ = parsed[0]
        packed = pack_frames([(fs, som) for fs, _, _, som in parsed],
                             sps, pps)
        mesh = make_mesh(devices=devices)
        recon_fused.wave_kernel_cuda.launches = 0
        recon_fused.wave_kernel_cuda.launches_by_device = {}
        planes_a = _Recon(mesh, "fused")(packed)[:3]
        launches = recon_fused.wave_kernel_cuda.launches
        by_card = dict(sorted(
            recon_fused.wave_kernel_cuda.launches_by_device.items()))
        for j, ci in enumerate(mine):
            _check([p[j] for p in planes_a], want(ci), f"A clip{ci}")
    print(f"mh[{pid}]: phase A OK — clips {mine} of {n_clips} parsed by "
          f"this process, reconstructed over {devices_per_proc} mesh "
          f"entries, wave_kernel launches {launches} by card {by_card}, "
          f"bit-exact ({time.time() - t:.2f}s)", flush=True)

    # ---- metrics reduce: one all_reduce of the frame counts ------------
    t = time.time()
    cnt = torch.tensor([len(mine)], dtype=torch.int64, device=dev)
    dist.all_reduce(cnt)
    total = int(cnt.item())
    if total != n_clips:
        raise RuntimeError(f"the processes own {total} of {n_clips} clips")
    print(f"mh[{pid}]: all_reduce frame-count reduce across processes = "
          f"{total} ({time.time() - t:.3f}s)", flush=True)

    # ---- phase B: the halo, one frame's lane axis over every process ---
    t = time.time()
    fs0 = parse(0)[0]
    wmb, hmb = fs0.width_mbs, fs0.height_mbs
    g = skew_tables(wmb, hmb)
    batch_b = 2          # the least whose lane axis divides over n_dev
    while (batch_b * g["maxw"]) % n_dev:      # (1080p's maxw 61 is prime)
        batch_b += 1
    fs_b = [parse(i % n_clips) for i in range(batch_b)]
    packed_b = pack_frames([(fs, som) for fs, _, _, som in fs_b],
                           fs_b[0][1], fs_b[0][2])
    g["wmb"], g["hmb"] = wmb, hmb
    W, L = g["n_waves"], batch_b * g["maxw"]
    staging = recon_fused.raster_feeds(
        {k: torch.as_tensor(v, device=dev)
         for k, v in packed_b.arrays.items()},
        *packed_b.chroma_qp_off, wmb, hmb, batch_b)
    feeds = lane_feeds(staging)
    n_ex = [0]

    def exchange(buf):
        dist.all_reduce(buf)
        n_ex[0] += 1
        return buf

    first = pid * devices_per_proc
    out_y, out_c = halo_loop(feeds, packed_b.ls4, packed_b.ls8, g, batch_b,
                             devices, first=first,
                             n_strips=n_dev, exchange=exchange,
                             has8x8=packed_b.has8x8,
                             haspcm=packed_b.haspcm)
    loop_s = time.time() - t
    # every process's lanes into one zeroed buffer: each lane has one
    # owner, so the sum is the owner's value
    full = torch.zeros((W, 384, L), dtype=torch.uint8, device=dev)
    lo = first * (L // n_dev)
    full[:, :256, lo:lo + out_y.shape[2]] = out_y
    full[:, 256:, lo:lo + out_c.shape[2]] = out_c
    dist.all_reduce(full)
    planes_b = [p.cpu().numpy() for p in recon_fused.unskew_fused(
        full[:, :256], full[:, 256:], g, batch_b)]
    halo_s = time.time() - t
    for i in range(batch_b):
        _check([p[i] for p in planes_b], want(i % n_clips), f"B pic {i}")
    print(f"mh[{pid}]: phase B OK — halo lane axis (L={L}) over {n_dev} "
          f"strips spans {nprocs} processes, {n_ex[0]} per-wave edge "
          f"all_reduces crossed the process boundary, all_reduces this "
          f"batch {n_ex[0] + 1} with the gather, bit-exact "
          f"x{batch_b} (loop {loop_s:.2f}s, with the gather "
          f"{halo_s:.2f}s, with the check {time.time() - t:.2f}s)",
          flush=True)
    if out_dir:
        np.savez(os.path.join(out_dir, f"mh_planes.{pid}.npz"),
                 a_clips=np.asarray(mine, np.int64),
                 **{f"a_{k}": p for k, p in zip(("y", "cb", "cr"),
                                                  planes_a)},
                 **{f"b_{k}": p for k, p in zip(("y", "cb", "cr"),
                                                  planes_b)})
    print(f"mh[{pid}]: MULTIHOST OK", flush=True)


# ---------------------------------------------------------------------------
# launcher

def worker_argv(pid: int, nprocs: int, init_method: str,
                devices_per_proc: int, device=None, clip_files=None,
                out_dir=None):
    """The arguments of main() for worker `pid`."""
    argv = ["--pid", str(pid), "--procs", str(nprocs),
            "--devices", str(devices_per_proc), "--init-method", init_method]
    if device is not None:
        argv += ["--device", str(device)]
    if clip_files:
        argv += ["--clips", *clip_files]
    if out_dir is not None:
        argv += ["--out", out_dir]
    return argv


def free_init_method() -> str:
    """A tcp:// store address on a free local port."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://localhost:{port}"


def run_multihost_dryrun(nprocs: int = 2, devices_per_proc: int = 2,
                         timeout: int = 600, device=None, clip_files=None,
                         out_dir=None) -> str:
    """Start nprocs workers and wait for them; returns their combined
    output.  Raises on any worker failure or missing OK marker, after
    stopping every worker.  The CUDA library and the native parser are
    built here once (the parser loaded, so that an override library
    builds nothing), before the workers start, so that they only load
    them."""
    from .. import native
    native.load()
    if device is None or str(device).startswith("cuda"):
        from ..ops import kernels
        kernels.build()
    init_method = free_init_method()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE,
         *worker_argv(i, nprocs, init_method, devices_per_proc, device,
                      clip_files, out_dir)],
        stdout=logs[i], stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(nprocs)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                      # one failed: stop the rest
            if time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIHOST OK" not in out:
            raise RuntimeError(
                f"multihost worker {i} failed (rc={p.returncode}):\n"
                + "\n".join(o[-3000:] for o in outs))
    return "\n".join(outs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the card)")
    ap.add_argument("--clips", nargs="*", default=None,
                    help="Annex-B files to read the clips from")
    ap.add_argument("--out", default=None,
                    help="directory for the manifests and the planes")
    a = ap.parse_args(argv)
    worker(a.pid, a.procs, a.init_method, a.devices, a.device, a.clips,
           a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

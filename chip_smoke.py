#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (minivideo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

  1. device  - a CUDA card must be present; prints its name and power
               limit as nvidia-smi reports them.
  2. build   - compiles the native entropy parser (g++) and the CUDA wave
               kernel (nvcc, sm_90a) from the checkout, both at once.
  3. stream  - encodes a seeded 1080p High-profile CAVLC stream of two
               IDR pictures (I16x16/I4x4/I8x8 and I_PCM macroblocks) with
               the port's fixture encoder and checks its SHA-256, then
               repeats the two pictures to a batch of 16.
  4. kernel  - every kernel of the path against its plain PyTorch
               version on the card: the wave kernel and the plain wave
               loop must give identical planes, on small streams with
               each feature (8x8, PCM, multi-slice, QP extremes, custom
               scaling lists) and on the 1080p batch.
  5. e2e     - decode_annexb() of the 16-picture stream on the card; the
               planes must equal the SHA-256 digests that the JAX
               package (minivideo_tpu, engine "fused") gives for the same
               stream, and the kernel's launch counter must have moved by
               n_waves for the one batch.
  6. timing  - CUDA-event medians per 1080p batch of the kernel and of
               the plain version, the bound, and decode_annexb pictures/s.

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Any failed phase exits non-zero
without that line.  The script imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# 1080p stream: make_stream(**STREAM_KW) from minivideo_tpu_torch.testing
STREAM_KW = dict(width_mbs=120, height_mbs=68, n_pictures=2, seed=2026,
                 profile=100, transform_8x8=True, allow_pcm=True,
                 mb_kinds=("i16", "i4", "i8"))
STREAM_SHA256 = ("f5ed8d3bf8a1157659e5466db616b279"
                 "af10c149ee3d4ade79d47911160193f2")
# (Y, Cb, Cr) SHA-256 per picture from the JAX package's
# decode_annexb(engine="fused") with device-layout staging, on the CPU
JAX_DIGESTS = [
    ["8ae7a13b16a072ca6817efd007a7b337eccbb8bdaf957f06c0f8a58f0874797a",
     "830be3aa98d7982a8b9415f4436d7efe1a0ebb6a1f97d088354d7319bc6f45b5",
     "95a65cae1aa41fdb4c2b4d540c0a110a5aa6254876da1ee5da68863c57170e6f"],
    ["0b53ce2220c315273e650896d87e4690079554997af8fed7d44cbbdd5a7a38ff",
     "b760a532bb780ed3afa4aa77995759ca419b3b2afd92a715a51e27032184f35b",
     "5f208c810cafa0b56004eb3dd83fae060dff5773d6bb84d26a966f76dcb28a1b"],
]
BATCH = 16
TIMED_RUNS = 5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak


def log(phase, t0, msg):
    print(f"[{phase}] {time.time() - t0:.2f}s {msg}", flush=True)


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def repeat_pictures(data, reps):
    """Annex-B stream with its IDR access units repeated `reps` times
    (one slice per picture): parameter sets, pictures, trailing NALUs."""
    from minivideo_tpu_torch.models.h264.nalu import split_annexb
    units = [raw for _, raw in split_annexb(data)]
    idr = [i for i, u in enumerate(units) if u[0] & 0x1F == 5]
    head, pics, tail = (units[:idr[0]], units[idr[0]:idr[-1] + 1],
                        units[idr[-1] + 1:])
    sc = b"\x00\x00\x00\x01"
    return b"".join(sc + u for u in head + pics * reps + tail)


def sha(a):
    return hashlib.sha256(a.tobytes()).hexdigest()


def cuda_ms(fn, runs):
    """Median CUDA-event milliseconds of fn() over `runs`, after a
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def profiled_kernel_ms(fn, name):
    """Device time of the kernels whose name holds `name` in one fn() run,
    from torch.profiler: (ms, kernel count), or None where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "device_time_total", 0) for e in events)
    return (us / 1e3, sum(e.count for e in events)) if us else None


def staged(stream, device, pool=None):
    """decode_annexb's front half for a one-part stream: (PackedFrames,
    staging tensors on `device`, host-clock seconds of each step)."""
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    secs = {}
    (_, packed, arrs), = stage_annexb(stream, device, pool, secs)
    return packed, arrs, secs


# bytes the wave kernel must move per MB (csrc/wave_kernel.cu, "Bound"):
# every real MB reads its meta row; a parsed one also reads its luma,
# chroma and 24 DC coefficient rows; each writes 256 + 128 plane bytes.
# Padding lanes of a wave read nothing.
META_BYTES, COEF_BYTES, PLANE_BYTES = 40 * 4, (256 + 128 + 24) * 2, 384


def wave_kernel_bytes(packed):
    """Bytes the wave kernel must move for `packed`'s batch: each input
    it reads once (meta, the coefficients of parsed MBs, the scale and
    tap tables), each output written once."""
    from minivideo_tpu_torch.ops.recon_lane import TAP_ROWS4, TAP_ROWS8
    from minivideo_tpu_torch.ops.slab import R_PARSED
    n_mbs = packed.batch * packed.wmb * packed.hmb
    n_parsed = int((packed.arrays["meta_slab"][:, :, R_PARSED] > 0).sum())
    tables = 4 * (packed.ls4.size + packed.ls8.size
                  + TAP_ROWS4.size + TAP_ROWS8.size)
    return (n_mbs * (META_BYTES + PLANE_BYTES) + n_parsed * COEF_BYTES
            + tables)


def compare_kernel(packed, arrs):
    """Run the CUDA kernel and the plain loop on the same staging on the
    card; returns max |kernel - plain| over all planes."""
    import torch
    from minivideo_tpu_torch.ops.recon_fused import (reconstruct_plain,
                                                     wave_kernel_cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    got = wave_kernel_cuda(*args, **kw)
    want = reconstruct_plain(*args, **kw)
    torch.cuda.synchronize()
    return max(int((a.int() - b.int()).abs().max())
               for a, b in zip(got, want))


def main():
    t0 = time.time()
    failed = []

    # ---- 1. device ---------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import minivideo_tpu_torch
    pkg = os.path.dirname(os.path.abspath(minivideo_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "minivideo_tpu_torch"):
        print(f"chip_smoke: minivideo_tpu_torch imported from {pkg}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    from minivideo_tpu_torch import native
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.ops.recon_wave import skew_tables
    from minivideo_tpu_torch.testing.h264enc import make_stream
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", t0, f"{kind} | nvidia-smi: {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build (both compilers at once) ---------------------------------
    builds = {}

    def build(name, fn):
        t = time.time()
        try:
            fn()
            builds[name] = (time.time() - t, None)
        except Exception as e:                # noqa: BLE001 - reported
            builds[name] = (time.time() - t, e)

    threads = [threading.Thread(target=build, args=a) for a in
               (("entropy.cc (g++)", native.build),
                ("wave_kernel.cu (nvcc sm_90a)", recon_fused.build_kernel))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, (secs, err) in builds.items():
        log("build", t0, f"{name}: {secs:.2f}s "
            + ("ok" if err is None else f"FAILED: {err}"))
        if err is not None:
            failed.append("build")
    if failed:
        return 1
    from minivideo_tpu_torch._build import LOGS
    for line in LOGS.get("mvt_wave_kernel", "").splitlines():
        if "ptxas info" in line and ("registers" in line or "smem" in line):
            log("build", t0, line.strip())

    # ---- 3. stream ---------------------------------------------------------
    t = time.time()
    data = make_stream(**STREAM_KW)
    digest = hashlib.sha256(data).hexdigest()
    ok = digest == STREAM_SHA256
    log("stream", t0, f"1080p x2 encoded in {time.time() - t:.2f}s, "
        f"{len(data)} bytes, sha256 {digest} "
        + ("ok" if ok else f"MISMATCH (want {STREAM_SHA256})"))
    if not ok:
        return 1
    stream = repeat_pictures(data, BATCH // 2)

    # ---- 4. kernel vs plain ------------------------------------------------
    small = [
        dict(width_mbs=5, height_mbs=4, n_pictures=3, seed=1),
        dict(width_mbs=7, height_mbs=5, n_pictures=3, seed=2, profile=100,
             transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3),
        dict(width_mbs=6, height_mbs=6, n_pictures=2, seed=3, qp=51,
             profile=100, transform_8x8=True, mb_kinds=("i8", "i4")),
        dict(width_mbs=6, height_mbs=3, n_pictures=2, seed=4, qp=0,
             allow_pcm=True, mb_kinds=("i16",)),
        dict(width_mbs=4, height_mbs=4, n_pictures=2, seed=5, profile=100,
             transform_8x8=True, mb_kinds=("i16", "i4", "i8"),
             scaling_lists=[(1, None)] * 8,
             pps_scaling_lists=[(1, list(range(8, 24)))] * 6
             + [(1, list(range(6, 70)))] * 2),
    ]
    t = time.time()
    errs = []
    for kw in small:
        packed, arrs, _ = staged(make_stream(**kw), dev)
        errs.append(compare_kernel(packed, arrs))
    packed, arrs, _ = staged(stream, dev)
    err1080 = compare_kernel(packed, arrs)
    ok = max(errs) == 0 and err1080 == 0
    log("kernel", t0, f"wave_kernel vs plain wave loop (tolerance 0): small "
        f"streams max|err| {errs}, 1080p B={BATCH} max|err| {err1080} "
        f"({time.time() - t:.2f}s) " + ("ok" if ok else "MISMATCH"))
    if not ok:
        failed.append("kernel")

    # ---- 5. end to end (the main path) -------------------------------------
    g = skew_tables(120, 68)
    t = time.time()
    recon_fused.wave_kernel_cuda.launches = 0
    pics = decode_annexb(stream)
    launches = recon_fused.wave_kernel_cuda.launches
    e2e_s = time.time() - t
    got = [[sha(p.y), sha(p.cb), sha(p.cr)] for p in pics]
    want = [JAX_DIGESTS[i % len(JAX_DIGESTS)] for i in range(BATCH)]
    ok_shape = (len(pics) == BATCH and pics[0].y.shape == (1088, 1920)
                and pics[0].cb.shape == (544, 960))
    ok = ok_shape and got == want and launches == g["n_waves"]
    log("e2e", t0, f"decode_annexb: {len(pics)} pictures in {e2e_s:.3f}s, "
        f"planes {'=' if got == want else '!='} JAX digests, wave_kernel "
        f"launches {launches} (n_waves {g['n_waves']}) "
        + ("ok" if ok else "FAILED"))
    if not ok:
        failed.append("e2e")

    # ---- 6. timing ---------------------------------------------------------
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    kernel_ms = cuda_ms(lambda: recon_fused.wave_kernel_cuda(*args, **kw),
                        TIMED_RUNS)
    plain_ms = cuda_ms(lambda: recon_fused.reconstruct_plain(*args, **kw),
                       TIMED_RUNS)
    nbytes = wave_kernel_bytes(packed)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    walls = []
    for _ in range(3):
        t = time.time()
        decode_annexb(stream)
        walls.append(time.time() - t)
    e2e_med = statistics.median(walls)
    # host-clock breakdown of one decode_annexb batch, step by step
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        steps = [staged(stream, dev, pool)[2] for _ in range(3)]
    split = {k: statistics.median(st[k] for st in steps) for k in steps[0]}
    # host time to enqueue the 254 launches (no sync): near the event
    # time above means the launches, not the card, set the pace
    enqueue = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        planes = recon_fused.wave_kernel_cuda(*args, **kw)
        enqueue.append(time.perf_counter() - t)
    split["kernel_enqueue"] = statistics.median(enqueue)
    try:
        prof = profiled_kernel_ms(
            lambda: recon_fused.wave_kernel_cuda(*args, **kw), "wave_kernel")
    except RuntimeError as e:                # a diagnostic, not a check
        prof = f"failed: {e}"
    log("timing", t0, "torch.profiler device time of wave_kernel per "
        "batch (ms, kernels): " + (str(prof) if prof else "not measured")
        + f" | card: {card}")
    torch.cuda.synchronize()
    t = time.time()
    [p.cpu() for p in planes]
    split["d2h"] = time.time() - t
    split["kernel"] = kernel_ms / 1e3
    log("timing", t0, "decode_annexb steps (host clock, s, median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" | card: {card}")
    log("timing", t0, f"per 1080p batch of {BATCH}: wave_kernel "
        f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
        f"ms ({nbytes} bytes); decode_annexb {BATCH / e2e_med:.2f} "
        f"pictures/s (median of 3, {e2e_med:.3f}s) | card: {card}")
    print(json.dumps({"kernels": [{
        "name": "wave_kernel", "route": "cuda",
        "source": "minivideo_tpu_torch/ops/csrc/wave_kernel.cu",
        "replaces": "minivideo_tpu/ops/recon_fused.py:80",
        "launches": launches, "max_abs_err": max(errs + [err1080]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"e2e_pictures_per_s": BATCH / e2e_med,
                      "batch": BATCH, "card": card}))
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

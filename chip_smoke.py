#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (minivideo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

  1. device     - a CUDA card must be present; prints its name and power
                  limit as nvidia-smi reports them.
  2. build      - compiles the native entropy parser (g++) and the CUDA
                  library (one nvcc per csrc/*.cu, sm_90a), all at once.
  3. stream     - encodes a seeded 1080p High-profile CAVLC stream of two
                  IDR pictures (I16x16/I4x4/I8x8 and I_PCM macroblocks)
                  with the port's fixture encoder and checks its SHA-256,
                  then repeats the two pictures to a batch of 16.
  4. kernel     - the wave kernel against its plain PyTorch version on the
                  card (identical planes): small streams with each feature
                  (8x8, PCM, multi-slice, QP extremes, custom scaling
                  lists) and shapes that stress the flags between rows
                  (one MB wide, one row, right edges, a 1080p-wide strip
                  of 3 slices, a batch of 1,200 with more rows than can be
                  resident), then the 1080p batch, run 5 more times with
                  identical planes.
  5. interleave - the interleave kernel against its plain version and
                  the library call (permute().contiguous()) on 1080p
                  tiles of a batch of 16 (identical bytes).
  6. e2e        - decode_annexb() of the 16-picture stream on the card;
                  the planes must equal the SHA-256 digests that the JAX
                  package (minivideo_tpu, engine "fused") gives for the
                  same stream, with one wave-kernel launch for the batch;
                  then tiles_to_raster_cuda() once, one launch.
  7. timing     - per 1080p batch of 16: CUDA-event time over
                  back-to-back calls of both kernels, of their plain
                  versions and of the interleave library call, and
                  torch.profiler device time of both kernels; the wave
                  kernel's times for one picture (B = 1); the bounds;
                  decode_annexb pictures/s with a host breakdown.

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

# the 1080p stream: make_stream(**STREAM_KW) from minivideo_tpu_torch.testing
from minivideo_tpu_torch.testing.streams import STREAM_1080P as STREAM_KW

HERE = os.path.dirname(os.path.abspath(__file__))
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
TIMED_RUNS = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published peak


CARD = []          # nvidia-smi's "name, power limit", once it is read


def log(phase, t0, msg):
    card = f" | card: {CARD[0]}" if CARD else ""
    print(f"[{phase}] {time.time() - t0:.2f}s {msg}{card}", flush=True)


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def sha(a):
    return hashlib.sha256(a.tobytes()).hexdigest()


def cuda_ms(fn, runs, reps=3):
    """Milliseconds per fn() call on the card: CUDA events around `runs`
    back-to-back calls, over the count, median of `reps` such groups,
    after a warm-up call.  The calls queue up behind each other, so the
    host's time to enqueue a call hides behind the card's work wherever
    it is shorter."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(runs):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / runs)
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
# every MB reads its meta row; a parsed one also reads its luma, chroma
# and 24 DC coefficient rows; each writes 256 + 128 plane bytes.
META_BYTES, COEF_BYTES, PLANE_BYTES = 40 * 4, (256 + 128 + 24) * 2, 384
# the small streams of the kernel phase: each feature of the kernel, then
# shapes that stress the flags between rows
SMALL = [
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
    dict(width_mbs=1, height_mbs=12, n_pictures=2, seed=6,
         mb_kinds=("i16", "i4")),
    dict(width_mbs=12, height_mbs=1, n_pictures=2, seed=7,
         mb_kinds=("i16", "i4")),
    dict(width_mbs=2, height_mbs=9, n_pictures=2, seed=8, profile=100,
         transform_8x8=True, mb_kinds=("i16", "i4", "i8")),
    dict(width_mbs=120, height_mbs=3, n_pictures=2, seed=9, profile=100,
         transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3,
         allow_pcm=True),
]
# a batch with more rows than can be resident at once (B * hmb = 4,800
# blocks against 132 SMs x 32): the stream of make_stream(**WIDE_KW)
# repeated to WIDE_BATCH pictures
WIDE_KW = dict(width_mbs=8, height_mbs=4, n_pictures=2, seed=10,
               mb_kinds=("i16", "i4"))
WIDE_BATCH = 1200
REPEATS = 5


def wave_kernel_bytes(packed):
    """Bytes the wave kernel must move for `packed`'s batch: each input
    it reads once (meta, the coefficients of parsed MBs, the scale and
    tap tables), each output written once."""
    from minivideo_tpu_torch.ops.recon_lane import TAP_ROWS4, TAP_ROWS8
    from minivideo_tpu_torch.ops.slab import R_PARSED
    n_mbs = packed.batch * packed.wmb * packed.hmb
    n_parsed = int((packed.arrays["meta_slab"][:, :, R_PARSED] > 0).sum())
    tables = (4 * (packed.ls4.size + packed.ls8.size)
              + TAP_ROWS4.size + TAP_ROWS8.size)    # int32, uint8
    return (n_mbs * (META_BYTES + PLANE_BYTES) + n_parsed * COEF_BYTES
            + tables)


def max_err(got, want):
    return max(int((a.int() - b.int()).abs().max())
               for a, b in zip(got, want))


def compare_kernel(packed, arrs):
    """Run the CUDA kernel and the plain loop on the same staging on the
    card; returns (max |kernel - plain| over all planes, kernel planes)."""
    import torch
    from minivideo_tpu_torch.ops.recon_fused import (reconstruct_plain,
                                                     wave_kernel_cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    got = wave_kernel_cuda(*args, **kw)
    want = reconstruct_plain(*args, **kw)
    torch.cuda.synchronize()
    return max_err(got, want), got


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
    from minivideo_tpu_torch.ops import interleave, kernels, recon_fused
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import repeat_pictures
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    CARD.append(card)
    kind = torch.cuda.get_device_name(0)
    log("device", t0, f"{kind} | nvidia-smi: {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build (every compiler at once) ---------------------------------
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
                ("csrc/*.cu (nvcc sm_90a, one per source, then link)",
                 kernels.build))]
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
    for line in LOGS.get(kernels.NAME, "").splitlines():
        if "ptxas info" in line and ("registers" in line or "smem" in line
                                     or "Compiling" in line):
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
    t = time.time()
    errs = []
    for kw in SMALL:
        packed, arrs, _ = staged(make_stream(**kw), dev)
        errs.append(compare_kernel(packed, arrs)[0])
    wide = repeat_pictures(make_stream(**WIDE_KW), WIDE_BATCH // 2)
    packed, arrs, _ = staged(wide, dev)
    err_wide = compare_kernel(packed, arrs)[0]
    packed, arrs, _ = staged(stream, dev)
    err1080, first = compare_kernel(packed, arrs)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    same = [all(torch.equal(a, b) for a, b in
                zip(recon_fused.wave_kernel_cuda(*args, **kw), first))
            for _ in range(REPEATS)]
    ok = max(errs) == 0 and err_wide == 0 and err1080 == 0 and all(same)
    log("kernel", t0, f"wave_kernel vs plain wave loop (tolerance 0): small "
        f"streams max|err| {errs}, {WIDE_KW['width_mbs']}x"
        f"{WIDE_KW['height_mbs']} B={WIDE_BATCH} max|err| {err_wide}, "
        f"1080p B={BATCH} max|err| {err1080}; {REPEATS} repeats identical: "
        f"{same} ({time.time() - t:.2f}s) " + ("ok" if ok else "MISMATCH"))
    if not ok:
        failed.append("kernel")

    # ---- 5. interleave vs plain and library --------------------------------
    t = time.time()
    wmb, hmb = packed.wmb, packed.hmb
    gen = torch.Generator(device=dev).manual_seed(2026)
    tiles = torch.randint(0, 256, (BATCH, wmb * hmb, 256), generator=gen,
                          device=dev, dtype=torch.uint8)

    def library():
        return tiles.view(BATCH, hmb, wmb, 16, 16).permute(
            0, 1, 3, 2, 4).contiguous().view(BATCH, 16 * hmb, 16 * wmb)

    got = interleave.tiles_to_raster_cuda(tiles, wmb, hmb)
    want = interleave.tiles_to_raster_plain(tiles, wmb, hmb)
    lib_out = library()
    torch.cuda.synchronize()
    err_il = max(max_err([got], [want]), max_err([got], [lib_out]))
    ok = err_il == 0 and got.shape == (BATCH, 16 * hmb, 16 * wmb)
    log("interleave", t0, f"tiles_to_raster_cuda vs plain and vs "
        f"permute().contiguous(), 1080p B={BATCH} (tolerance 0): max|err| "
        f"{err_il} ({time.time() - t:.2f}s) " + ("ok" if ok else "MISMATCH"))
    if not ok:
        failed.append("interleave")

    # ---- 6. end to end (the main paths) ------------------------------------
    t = time.time()
    recon_fused.wave_kernel_cuda.launches = 0
    interleave.tiles_to_raster_cuda.launches = 0
    pics = decode_annexb(stream)
    launches = recon_fused.wave_kernel_cuda.launches
    il_other = interleave.tiles_to_raster_cuda.launches
    e2e_s = time.time() - t
    got = [[sha(p.y), sha(p.cb), sha(p.cr)] for p in pics]
    want = [JAX_DIGESTS[i % len(JAX_DIGESTS)] for i in range(BATCH)]
    ok_shape = (len(pics) == BATCH and pics[0].y.shape == (1088, 1920)
                and pics[0].cb.shape == (544, 960))
    ok = ok_shape and got == want and launches == 1 and il_other == 0
    log("e2e", t0, f"decode_annexb: {len(pics)} pictures in {e2e_s:.3f}s, "
        f"planes {'=' if got == want else '!='} JAX digests, wave_kernel "
        f"launches {launches} (want 1 per batch), interleave launches "
        f"{il_other} (want 0) " + ("ok" if ok else "FAILED"))
    if not ok:
        failed.append("e2e")
    recon_fused.wave_kernel_cuda.launches = 0
    interleave.tiles_to_raster_cuda.launches = 0
    raster = interleave.tiles_to_raster_cuda(tiles, wmb, hmb)
    torch.cuda.synchronize()
    il_launches = interleave.tiles_to_raster_cuda.launches
    ok = (il_launches == 1 and recon_fused.wave_kernel_cuda.launches == 0
          and torch.equal(raster, lib_out))
    log("e2e", t0, f"tiles_to_raster_cuda: interleave launches "
        f"{il_launches} (want 1) " + ("ok" if ok else "FAILED"))
    if not ok:
        failed.append("e2e interleave")

    # ---- 7. timing ---------------------------------------------------------
    def wave(a=arrs, check=False):
        return recon_fused.wave_kernel_cuda(
            *a, packed.ls4, packed.ls8, wmb, hmb, check=check, **kw)

    one = [x[:1] for x in arrs]            # the first picture alone
    kernel_ms = cuda_ms(wave, TIMED_RUNS)
    kernel1_ms = cuda_ms(lambda: wave(one), TIMED_RUNS)
    plain_ms = cuda_ms(lambda: recon_fused.reconstruct_plain(*args, **kw),
                       1)
    nbytes = wave_kernel_bytes(packed)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    il_ms = cuda_ms(lambda: interleave.tiles_to_raster_cuda(tiles, wmb, hmb),
                    TIMED_RUNS)
    il_plain_ms = cuda_ms(
        lambda: interleave.tiles_to_raster_plain(tiles, wmb, hmb),
        TIMED_RUNS)
    il_lib_ms = cuda_ms(library, TIMED_RUNS)
    il_bytes = 2 * tiles.numel()
    il_bound_ms = il_bytes / HBM_BYTES_PER_S * 1e3
    prof = {}
    for name, fn, kname in (
            ("wave_kernel B=16", wave, "wave_kernel"),
            ("wave_kernel B=1", lambda: wave(one), "wave_kernel"),
            ("interleave_kernel B=16",
             lambda: interleave.tiles_to_raster_cuda(tiles, wmb, hmb),
             "interleave_kernel")):
        try:
            prof[name] = profiled_kernel_ms(fn, kname)
        except RuntimeError as e:            # a diagnostic, not a check
            prof[name] = f"failed: {e}"
    log("timing", t0, "torch.profiler device time per call (ms, kernels): "
        + "; ".join(f"{k} {v if v else 'not measured'}"
                    for k, v in prof.items()))
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
    # host time to enqueue the batch's launch (no sync)
    enqueue = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        planes = wave()
        enqueue.append(time.perf_counter() - t)
    split["kernel_enqueue"] = statistics.median(enqueue)
    # raises if a wait for the row above timed out in any launch above that
    # went unchecked (every timed, profiled and enqueued one)
    recon_fused.check_waits()
    t = time.time()
    [p.cpu() for p in planes]
    split["d2h"] = time.time() - t
    split["kernel"] = kernel_ms / 1e3
    log("timing", t0, "decode_annexb steps (host clock, s, median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log("timing", t0, f"per 1080p batch of {BATCH}: wave_kernel "
        f"{kernel_ms:.3f} ms (B=1: {kernel1_ms:.3f} ms, "
        f"{kernel1_ms / (2 * hmb + wmb - 2) * 1e3:.2f} us per dependent "
        f"MB step), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes} bytes); interleave {il_ms:.4f} ms, plain "
        f"{il_plain_ms:.4f} ms, permute().contiguous() {il_lib_ms:.4f} ms, "
        f"bound {il_bound_ms:.4f} ms ({il_bytes} bytes); decode_annexb "
        f"{BATCH / e2e_med:.2f} pictures/s (median of 3, {e2e_med:.3f}s)")
    print(json.dumps({"kernels": [
        {"name": "wave_kernel", "route": "cuda",
         "source": "minivideo_tpu_torch/ops/csrc/wave_kernel.cu",
         "replaces": "minivideo_tpu/ops/recon_fused.py:80",
         "launches": launches, "max_abs_err": max(errs + [err_wide,
                                                          err1080]),
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": "bytes", "library_ms": None},
        {"name": "interleave_kernel", "route": "cuda",
         "source": "minivideo_tpu_torch/ops/csrc/interleave_kernel.cu",
         "replaces": "tools/probe_interleave.py:100",
         "launches": il_launches, "max_abs_err": err_il,
         "ms": il_ms, "plain_ms": il_plain_ms, "bound_ms": il_bound_ms,
         "bound_by": "bytes", "library_ms": il_lib_ms}], "card": card}))
    print(json.dumps({"e2e_pictures_per_s": BATCH / e2e_med,
                      "batch": BATCH, "wave_kernel_b1_ms": kernel1_ms,
                      "card": card}))
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

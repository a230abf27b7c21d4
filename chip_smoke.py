#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (minivideo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

  1. device     - a CUDA card must be present; prints its name and power
                  limit as nvidia-smi reports them.
  2. build      - compiles the native entropy parser, demuxer and picture
                  encoders (g++; export.cc with -march=native and zlib)
                  and the CUDA library (one nvcc per csrc/*.cu, sm_90a),
                  all at once.
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
                  back-to-back calls of both kernels, of the interleave
                  kernel's plain version and library call (the wave
                  kernel's plain loop, seconds a run, is timed once in
                  phase 4), and
                  torch.profiler device time of both kernels; the wave
                  kernel's times for one picture (B = 1); the bounds;
                  decode_annexb pictures/s with a host breakdown.
  8. cabac      - a seeded 1080p CABAC stream of two IDR pictures (8x8,
                  I_PCM) from the port's make_stream2, SHA-256 pinned,
                  repeated to 16 pictures and decoded on the card: the
                  JAX package's digests, one launch, and its host-clock
                  breakdown and pictures/s.
  9. containers - the 1080p CAVLC batch written into an MP4, a Matroska
                  and an MPEG-TS file, and the CABAC batch into an MP4
                  (testing/containers.py), each decoded through mv_open,
                  mv_parse and mv_decode on the card: the JAX digests, 16
                  pictures, one launch, and the host-clock split into
                  demux, stream assembly and decode_annexb with
                  pictures/s; every run must go through the native
                  demuxer.  Then RGB output (want_rgb=True) from the
                  CAVLC MP4: every picture's RGB equals the JAX package's
                  (RGB_DIGESTS) and the port's numpy converter, with the
                  RGB op's time on resident planes, the numpy converter's
                  on the read-back pictures, and pictures/s with and
                  without RGB.  Then the Python demuxers
                  (MINIVIDEO_TPU_NO_NATIVE=1) on the MP4 and Matroska
                  files: tables equal to the native demuxer's, and the
                  pictures decoded from the Python tables give the JAX
                  digests.
 10. files      - the same 1080p CAVLC and CABAC batches written into AVI,
                  MPEG-PS and raw ES files and decoded through mv_open,
                  mv_parse and mv_decode on the card with the native
                  demuxer: the AVI and ES files give the JAX digests with
                  one launch, the MPEG-PS files what the JAX package gives
                  (PS_DIGESTS: no picture), the Python demuxers' tables
                  equal the native ones, with demux, stream assembly and
                  pictures/s; the 1080p stream with custom scaling lists
                  (SCALING_LISTS) repeated to 16 pictures through
                  decode_annexb gives SCALING_DIGESTS with one launch; the
                  extractor (ES, PES) and the analyser (--json) on the AVI
                  and MPEG-PS files give the JAX apps' outputs
                  (APP_DIGESTS).
 11. staging    - the 1080p CAVLC batch through the three staging layouts
                  (MINIVIDEO_TPU_STAGING=device and =records through
                  decode_annexb; raster: the full native parse, pack_frames
                  and reconstruct_batch), each giving the JAX digests with
                  one launch; per layout parse s, h2d s and bytes, feed
                  prep and kernel ms (CUDA events), pictures/s.  Then the
                  four staging constants of minivideo_tpu_torch/settings.py
                  measured on this host, and what "auto" picks.
 12. parsers    - small CAVLC and CABAC streams (8x8, I_PCM, 3 slices)
                  decoded under MINIVIDEO_TPU_NO_NATIVE=1 (the Python
                  parsers) equal the native parse's planes.
 13. bad slices - streams with bad IDR pictures (testing/streams.py
                  BAD_STREAMS) give the JAX package's pictures, digests
                  pinned, as the reference drops the bad ones.
 14. thumbnails - batch_thumbnail (parallel/batch.py) on the card over 19
                  files: the two 1080p CAVLC pictures alternating in 8
                  MP4, 4 Matroska and 4 MPEG-TS files, the CABAC MP4, a
                  4x3-MB clip and a 4x3-MB clip whose slice data is
                  corrupt.  Two buckets, so two wave-kernel launches; the
                  corrupt clip fails, its picture is black and the kernel
                  equals its plain version on that bucket; YUV420 files
                  give the JAX digests, PNG pixels (inflated and
                  unfiltered here: PNG bytes depend on the encoder's
                  thread count) RGB_DIGESTS, JPEG bytes JPEG_DIGESTS (the
                  JAX package's native JPEG); a second call skips every
                  done clip.  StageTimer's stages and thumbnails/s per
                  format (median of 3); the card's RGB op plus its
                  readback against the native host converter; PNG
                  encoding as the export pool runs it (8 workers x one
                  band per hardware thread) against one band each and
                  one worker; the thumbnailer CLI (-n 16 -f png) on the
                  16-picture MP4; mv_extract of its video track to ES
                  (SHA-256 pinned), decoded on the card to the JAX
                  digests.
 15. engines    - the "wave" and "np" engines and the lane loop, which
                  launch neither kernel (torch ops on the card; numpy on
                  the host): decode_annexb(engine="wave") of the 1080p
                  CAVLC and CABAC batches of 16 gives the JAX digests from
                  planes computed on the card with no wave-kernel launch,
                  with s per batch, pictures/s (median of 3) and peak
                  memory (CAVLC), and the CUDA launches of a batch
                  (torch.profiler, CABAC); reconstruct_frames_lane (the
                  loop that the wave engine runs, so the CABAC trace
                  counts its launches) of the CAVLC raster batch gives
                  the JAX digests, with its seconds and peak memory;
                  build_residuals on the card equals it on the CPU, with
                  its ms; decode_annexb(engine="np", max_pictures=2) gives
                  the first two JAX digests, s per picture; on the kernel
                  phase's small streams wave (card) = fused (card) = np;
                  the BAD_STREAMS through wave and np give BAD_DIGESTS;
                  batch_thumbnail(engine="wave", YUV420) over the 16 CAVLC
                  1080p files gives the JAX digests.
 16. scaleout   - the scale-out layer (parallel/sharding.py, halo.py,
                  multihost.py) with meshes and process groups whose
                  members share the card: (a) batch_thumbnail over a 2x2
                  mesh of the card and the thumbnails phase's 19 files,
                  YUV420 and PNG: the pinned digests, 4 wave-kernel
                  launches per bucket (8), the corrupt clip black and
                  failed, the stage times; (b) the halo in one process:
                  the 1080p CAVLC and CABAC pairs (batch 2) over 2 strips
                  give the first two JAX digests (the CABAC run traced
                  with torch.profiler for its CUDA launches), and a 6x5-MB
                  pair over 4 strips, a frame boundary on a strip
                  boundary, gives the fused kernel's and np's planes;
                  (c) run_multihost_dryrun with 2 processes on the card,
                  2 mesh entries each, over 4 1080p CAVLC clip files:
                  phase A 2 launches per process, the count reduce 4,
                  phase B's 1080p halo across both processes, every
                  picture of both phases equal to the JAX digests in both
                  processes, the backend and the seconds per phase.
 17. bench      - (a) a real encoder's stream (testing/streams.X264_STREAM:
                  libx264, 128x96, 2 pictures, 4 slices, CABAC with 8x8;
                  this host has no libavcodec) decoded on the card: its
                  pictures equal libavcodec's digests, one launch; (b) the
                  port's bench (minivideo_tpu_torch/bench.py, BENCH_ARGS)
                  in-process on the 1080p streams with
                  MINIVIDEO_TPU_PROFILE set to a scratch directory: its
                  output check (both staging layouts and 8x8 bit-exact
                  with the numpy oracle) and its checked pipeline runs
                  (every batch of 4 streams equal to the first and to the
                  oracle) must hold, the traces of the device stage and of
                  a pipeline run must count one wave-kernel launch per
                  batch and, for the run, 7 copy calls per batch (host
                  side: the profiler drops some of the card's records in
                  a process this old; the card's kernel and copy records
                  are printed beside), and the launches counted must
                  equal the bench's own; its JSON line's figures and the
                  trace counts are printed.

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Any failed phase exits non-zero
without that line.  The script imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

# the 1080p streams: make_stream(**STREAM_KW) and
# make_stream2(**CABAC_KW) from minivideo_tpu_torch.testing
from minivideo_tpu_torch.testing.streams import STREAM_1080P as STREAM_KW
from minivideo_tpu_torch.testing.streams import \
    STREAM_1080P_CABAC as CABAC_KW

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
CABAC_SHA256 = ("47abca06a9b44886bff5f606e8289eb7"
                "45dee59302a2c5e819faca9a53355dc2")
CABAC_DIGESTS = [
    ["ee2f93b7dbd40d5c88ae0fecf937a55af18c8bc67b4283cba54cf523d7407141",
     "6dd4725d5635ff57ac5214a96ef437b1a49060c7aa24ea8681193ebb79076a36",
     "abb3b18eb746b571533a6741a138c60e4dbf3349ac734129320e71d424d1d2d7"],
    ["b7288174c4c771a5d50ff377919850cc3b29bc89c696d23b4f6f70744f426b4c",
     "1e039dacf90d6ab54992f0426bbb2a940ff3cfca462f73ddd9b42a71e7afb677",
     "8dfaa6b9fffa8e9f628ed3aafdeb3ffc945fe7f039565503a2197b46f715bc5a"],
]
# SHA-256 of the RGB888 [1088, 1920, 3] of each picture: the JAX
# package's yuv420_to_rgb_device on its planes (decode_annexb(engine=
# "fused", want_rgb=True)), on the CPU
RGB_DIGESTS = [
    "4f33a8b0805bf8d2447abe9949c77acfb3c311526536110dca08b4ff01c6498c",
    "d6d56ae3c47f373a42c5b64cbc38b054d8dc4bf5817d99d6c37f1d58595fb398",
]
# per stream of testing/streams.BAD_STREAMS, the pictures the JAX package
# returns (its decode_annexb, engine "fused" and "np" alike)
BAD_DIGESTS = {
    "truncated_idr": [
        ["4585f2456e4245d38dc295f76f1f704c68ee5584f5fc98624c37b2483b2a401b",
         "a4adb0c526cf577421ab84264ce61e4f350331e7e50e11a35d43571780dbf471",
         "39ebe1e7c826135b04f861c8a0136fa712fe96fadbf92e2461e7560f4f3da271"],
        ["9c67fb88d57fc5fad544ec879600d30b027d71819d82eedaa44047179a7053a3",
         "f53cac44726c561118e86d2930191c696bd6546952593cbc108791cb4295a82f",
         "f8727211baea0c68ffa14cd7b208e87ff9a1cbaf6de9a17f1470300614d5da76"],
    ],
    "joined_id0": [
        ["f9fac68078d01dd07a913282edbed03b9a773fa7df0a0a3242a4022875e81486",
         "d079942d349333abb83efca2a2e17442c867bdb1101e3efe254a7110d5f78ab4",
         "e18e7add39cee15df7a86bc0791e3d09e626983900372ebf4e804e23bde6c09b"],
        ["85853fe670f67e71a13008dc8b496a56ad317e18eb411978265ad6d26b33a4b4",
         "5857fb600413b1de9acd015e73e392b9f96b0ae20e1cd75c60ef7b942ce699ad",
         "63b8603d88fe40d67a2060001490b3c86ecd4a8bf684dfde7523e2db196c3e89"],
    ],
    "error_run": [
        ["0c58623b0693357b722982fdca265fa36cb88479974a8809cf62844c81577d4d",
         "b77cfdf8433b4fcdc6c850f7fdf2d2a913599f7de1fdd6f9e663e969c50fd002",
         "4e2e97be6b376916bf98ef30d5cc3b04d7f337abf8fe312d36619a6b4b2a9a0c"],
        ["a85453dfff9ab8e876bdc2ab824a8489cf5e09e08470afbed2b6879eb7aad8a0",
         "76d25577c7badff709705031d2830fe9defc0d849b430491c4f339449c6953eb",
         "0b1335202bbec4f1ccc846c3134d3718dc3e9f0867544cca7cba01df33aa0d2b"],
        ["eb9c8ef757393ea1f893864e7cbf9e9aa35b41ebc0b62ddc3cfe70efc84402ef",
         "2ec4e78ff82633759d9967e841992c3573765783505e4aaceb0e53a1f181ce74",
         "2ec4e78ff82633759d9967e841992c3573765783505e4aaceb0e53a1f181ce74"],
    ],
}
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


def staged(stream, device, pool=None, mode="device"):
    """decode_annexb's front half for a one-part stream in staging layout
    `mode` (None: the one settings.staging_mode() picks): (PackedFrames
    on `device`, its device-layout staging tensors where mode is
    "device", host-clock seconds of each step)."""
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    from minivideo_tpu_torch.ops.recon_fused import DEVICE_STAGING
    secs = {}
    (_, packed), = stage_annexb(stream, device, pool, secs, mode)
    arrs = ([packed.arrays[k] for k in DEVICE_STAGING]
            if packed.slots == 2 else None)
    return packed, arrs, secs


def digests(pics):
    return [[sha(p.y), sha(p.cb), sha(p.cr)] for p in pics]


class env:
    """Set environment variables for a `with` block, then restore them."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kw}
        os.environ.update(self.kw)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    from minivideo_tpu_torch.ops.recon_wave import TAP_ROWS4, TAP_ROWS8
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
    card; returns (max |kernel - plain| over all planes, kernel planes,
    the plain loop's milliseconds by CUDA events)."""
    import torch
    from minivideo_tpu_torch.ops.recon_fused import (reconstruct_plain,
                                                     wave_kernel_cuda)
    args = (*arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    got = wave_kernel_cuda(*args, **kw)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    want = reconstruct_plain(*args, **kw)
    e.record()
    e.synchronize()
    return max_err(got, want), got, s.elapsed_time(e)


def breakdown(stream, dev, mode=None):
    """Host-clock seconds of decode_annexb's front half by step (NALUs,
    parse, h2d), median of 3, with the parse pool decode_annexb uses."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        steps = [staged(stream, dev, pool, mode)[2] for _ in range(3)]
    return {k: statistics.median(st[k] for st in steps) for k in steps[0]}


def decode_counted(fn):
    """(fn()'s result, wave kernel launches in that call): the count is set
    to 0 just before and read just after."""
    from minivideo_tpu_torch.ops import recon_fused
    recon_fused.wave_kernel_cuda.launches = 0
    out = fn()
    return out, recon_fused.wave_kernel_cuda.launches


def median_s(fn, reps=3):
    import torch
    walls = []
    for _ in range(reps):
        t = time.time()
        fn()
        torch.cuda.synchronize()
        walls.append(time.time() - t)
    return statistics.median(walls)


def phase_cabac(t0, dev, streams):
    """The 1080p CABAC batch of 16 on the card against the JAX digests,
    with its native CABAC bins per picture; adds it to `streams` as
    "cabac"."""
    from minivideo_tpu_torch import native
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    from minivideo_tpu_torch.testing.streams import repeat_pictures
    t = time.time()
    data = make_stream2(**CABAC_KW)
    digest = hashlib.sha256(data).hexdigest()
    log("cabac", t0, f"1080p CABAC x2 encoded in {time.time() - t:.2f}s, "
        f"{len(data)} bytes, sha256 {digest} "
        + ("ok" if digest == CABAC_SHA256 else
           f"MISMATCH (want {CABAC_SHA256})"))
    if digest != CABAC_SHA256:
        return False
    stream = repeat_pictures(data, BATCH // 2)
    streams["cabac"], streams["cabac2"] = stream, data
    t = time.time()
    pics, launches = decode_counted(lambda: decode_annexb(stream))
    first_s = time.time() - t
    got = digests(pics)
    want = [CABAC_DIGESTS[i % len(CABAC_DIGESTS)] for i in range(BATCH)]
    ok = (got == want and launches == 1
          and pics[0].y.shape == (1088, 1920))
    e2e = median_s(lambda: decode_annexb(stream))
    split = breakdown(stream, dev)
    bins = native.cabac_bins_total()
    decode_annexb(stream)
    bins = native.cabac_bins_total() - bins
    log("cabac", t0, f"native CABAC bins: {bins} per batch of {BATCH}, "
        f"{bins / BATCH / 1e6:.4f} Mbins per 1080p picture "
        f"(native.cabac_bins_total)")
    ok = ok and bins > 0
    log("cabac", t0, f"decode_annexb: {len(pics)} pictures in "
        f"{first_s:.3f}s, planes {'=' if got == want else '!='} JAX "
        f"digests, wave_kernel launches {launches} (want 1 per batch); "
        f"steps (host clock, s, median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; decode_annexb {BATCH / e2e:.2f} pictures/s (median of 3, "
        f"{e2e:.3f}s) " + ("ok" if ok else "FAILED"))
    return ok


def phase_staging(t0, dev, streams):
    """The 1080p CAVLC and CABAC batches through the three staging
    layouts, with their times, then the staging constants of settings.py
    measured here on the CAVLC batch."""
    import torch
    from minivideo_tpu_torch import settings
    from minivideo_tpu_torch.models.h264.decoder import (H264Decoder,
                                                        decode_annexb,
                                                        stage_annexb)
    from minivideo_tpu_torch.ops import recon_fused
    ok = True
    fps = {}
    runs = [(e, m) for e in ("cavlc", "cabac") if e in streams
            for m in ("device", "records", "raster")]
    for entropy, mode in runs:
        stream = streams[entropy]
        pinned = JAX_DIGESTS if entropy == "cavlc" else CABAC_DIGESTS
        want = [pinned[i % len(pinned)] for i in range(BATCH)]
        packed, _, _ = staged(stream, dev, None, mode)
        split = breakdown(stream, dev, mode)
        h2d_bytes = sum(a.numel() * a.element_size()
                        for a in packed.arrays.values())
        feeds = {"raster": recon_fused.raster_feeds,
                 "records": recon_fused.records_feeds}.get(mode)
        cq = packed.chroma_qp_off
        if feeds is None:
            arrs = [packed.arrays[k] for k in recon_fused.DEVICE_STAGING]
            feed_ms = 0.0
        else:
            def prep():
                return feeds(packed.arrays, *cq, packed.wmb, packed.hmb,
                             packed.batch)
            arrs = prep()
            feed_ms = cuda_ms(prep, 5)
        kernel_ms = cuda_ms(lambda: recon_fused.wave_kernel_cuda(
            *arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb,
            has8x8=packed.has8x8, haspcm=packed.haspcm, check=False), 10)
        recon_fused.check_waits()
        if mode == "raster":
            def run():
                (parsed, pk), = stage_annexb(stream, dev, staging_mode=mode)
                return H264Decoder(device=dev).reconstruct_batch(parsed, pk)
        else:
            def run(mode=mode):
                with env(MINIVIDEO_TPU_STAGING=mode):
                    return decode_annexb(stream)
        pics, launches = decode_counted(run)
        good = digests(pics) == want and launches == 1
        ok = ok and good
        e2e = median_s(run)
        fps[entropy, mode] = BATCH / e2e
        log("staging", t0, f"{entropy} {mode}: parse {split['parse']:.4f}s, "
            f"h2d {split['h2d']:.4f}s {h2d_bytes} bytes, feed prep "
            f"{feed_ms:.3f} ms, kernel {kernel_ms:.3f} ms, e2e "
            f"{BATCH / e2e:.2f} pictures/s (median of 3, {e2e:.3f}s); planes "
            f"{'=' if digests(pics) == want else '!='} JAX digests, "
            f"launches {launches} (want 1) " + ("ok" if good else "FAILED"))

    # the staging constants: the native parse on one thread, and the
    # card's drain (staging copy, feeds, kernel) over several batches
    stream = streams["cavlc"]
    consts = {}
    for mode, tag in (("records", "RECORDS"), ("device", "DEVICE")):
        parse = statistics.median(
            staged(stream, dev, None, mode)[2]["parse"] for _ in range(3))
        consts[f"HOST_MS_{tag}"] = parse / BATCH * 1e3
        packed, _, _ = staged(stream, dev, None, mode)
        host = dataclasses.replace(packed, arrays={
            k: v.cpu().numpy() for k, v in packed.arrays.items()})
        reps = 5
        recon_fused.reconstruct_frames_fused(host, dev)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(reps):
            recon_fused.reconstruct_frames_fused(host, dev)
        torch.cuda.synchronize()
        consts[f"DEVICE_FPS_{tag}"] = BATCH * reps / (time.time() - t)
    cores = os.cpu_count()
    for k, v in consts.items():
        log("staging", t0, f"{k} = {v!r}")
    log("staging", t0, f"os.cpu_count() = {cores}")
    cross = max(1, math.floor(consts["DEVICE_FPS_RECORDS"]
                              * consts["HOST_MS_DEVICE"] / 1000.0) + 1)
    measured_pick = "device" if cores >= cross else "records"
    with env(MINIVIDEO_TPU_STAGING="auto"):
        auto = settings.staging_mode()
    faster = max(("device", "records"), key=lambda m: fps["cavlc", m])
    log("staging", t0, f"auto picks {auto} with settings.py's constants "
        f"(crossover {settings.staging_crossover_cores()} cores), "
        f"{measured_pick} with this run's (crossover {cross} cores); "
        f"measured faster here: {faster}")
    return ok


# Track columns and metadata the native and Python demuxers must agree on
TRACK_FIELDS = ("stream_type", "stream_fcc", "stream_codec", "width",
                "height", "framerate", "framerate_num", "framerate_base",
                "frame_count", "frame_count_idr", "stream_size", "bitrate",
                "nal_length_size", "length_prefixed", "parameter_sets",
                "sample_type", "sample_size", "sample_offset", "sample_pts",
                "sample_dts")


def same_tracks(a, b):
    """Whether two MediaFiles' tracks agree on TRACK_FIELDS (arrays element
    by element, dtypes included)."""
    import numpy as np
    if len(a.tracks) != len(b.tracks):
        return False
    for ta, tb in zip(a.tracks, b.tracks):
        for f in TRACK_FIELDS:
            va, vb = getattr(ta, f), getattr(tb, f)
            if isinstance(va, np.ndarray):
                if va.dtype != vb.dtype or not np.array_equal(va, vb):
                    return False
            elif va != vb:
                return False
    return True


def mv_decode_split(path, **kw):
    """mv_open, mv_parse and mv_decode of `path` on the card: (pictures,
    host-clock seconds of demux, stream assembly and decode_annexb).
    mv_decode imports decode_annexb at each call, so the decoder module's
    name is wrapped here to time it.  demux() imports native_demux at
    each call too, and falls back to the Python demuxers without a word
    where it returns False: its name is wrapped here as well, and the
    call raises unless the native demuxer ran and succeeded."""
    from minivideo_tpu_torch.api import mv_close, mv_decode, mv_open, mv_parse
    from minivideo_tpu_torch.containers import native
    from minivideo_tpu_torch.models.h264 import decoder
    real = decoder.decode_annexb
    real_demux = native.native_demux
    secs = {}
    demuxed = []

    def native_counted(media):
        demuxed.append(real_demux(media))
        return demuxed[-1]

    def timed(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)          # returns host arrays: synchronised
        secs["decode_annexb"] = time.perf_counter() - t
        return out

    native.native_demux = native_counted
    t = time.perf_counter()
    media = mv_open(path)
    try:
        if not mv_parse(media, audio=False, subs=False):
            raise RuntimeError(f"mv_parse failed on {path}")
        secs["demux"] = time.perf_counter() - t
        if demuxed != [True]:
            raise RuntimeError(f"the native demuxer did not demux {path} "
                               f"(native_demux returned {demuxed})")
        decoder.decode_annexb = timed
        t = time.perf_counter()
        pics = mv_decode(media, picture_number=BATCH, **kw)
        total = time.perf_counter() - t
    finally:
        decoder.decode_annexb = real
        native.native_demux = real_demux
        mv_close(media)
    secs["assembly"] = total - secs["decode_annexb"]
    secs["total"] = secs["demux"] + total
    return pics, secs


def phase_containers(t0, dev, streams):
    """The 1080p batches from MP4, Matroska and MPEG-TS files through the
    user's entry points, RGB output, and the Python demuxers against the
    native one."""
    import tempfile
    import numpy as np
    from minivideo_tpu_torch.api import mv_close, mv_decode, mv_open, mv_parse
    from minivideo_tpu_torch.containers.native import native_demux
    from minivideo_tpu_torch.export.image import yuv420_to_rgb_py
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.ops.color import yuv420_to_rgb_device
    from minivideo_tpu_torch.testing import containers as C
    ok = True
    writers = {"mp4": lambda s: C.write_mp4(s, 1920, 1088),
               "mkv": lambda s: C.write_mkv(s, 1920, 1088),
               "ts": C.write_ts}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        files = {}
        for entropy, fmt in (("cavlc", "mp4"), ("cavlc", "mkv"),
                             ("cavlc", "ts"), ("cabac", "mp4")):
            path = os.path.join(tmp, f"{entropy}.{fmt}")
            with open(path, "wb") as f:
                f.write(writers[fmt](streams[entropy]))
            files[entropy, fmt] = path
        totals = {}
        for (entropy, fmt), path in files.items():
            pinned = JAX_DIGESTS if entropy == "cavlc" else CABAC_DIGESTS
            want = [pinned[i % len(pinned)] for i in range(BATCH)]
            # the counted run is the first of the three timed ones
            (pics, first), launches = decode_counted(
                lambda: mv_decode_split(path))
            splits = [first] + [mv_decode_split(path)[1] for _ in range(2)]
            split = {k: statistics.median(sp[k] for sp in splits)
                     for k in splits[0]}
            totals[entropy, fmt] = split["total"]
            good = (digests(pics) == want and len(pics) == BATCH
                    and launches == 1)
            ok = ok and good
            log("containers", t0, f"{entropy} {fmt} "
                f"({os.path.getsize(path)} bytes): mv_decode {len(pics)} "
                f"pictures, planes {'=' if digests(pics) == want else '!='} "
                f"JAX digests, wave_kernel launches {launches} (want 1); "
                f"host clock, s, median of 3: demux (native) "
                f"{split['demux']:.4f}, stream assembly "
                f"{split['assembly']:.4f}, decode_annexb "
                f"{split['decode_annexb']:.4f}; "
                f"{BATCH / split['total']:.2f} pictures/s "
                + ("ok" if good else "FAILED"))

        # RGB output on the card
        path = files["cavlc", "mp4"]
        (pics, first), launches = decode_counted(
            lambda: mv_decode_split(path, want_rgb=True))
        rgb_want = [RGB_DIGESTS[i % len(RGB_DIGESTS)] for i in range(BATCH)]
        rgb_got = [sha(p.rgb) for p in pics]
        host_same = all(np.array_equal(p.rgb, yuv420_to_rgb_py(p.y, p.cb,
                                                                p.cr))
                        for p in pics)
        good = (rgb_got == rgb_want and host_same and launches == 1
                and pics[0].rgb.shape == (1088, 1920, 3)
                and digests(pics) == [JAX_DIGESTS[i % 2]
                                      for i in range(BATCH)])
        ok = ok and good
        packed, _, _ = staged(streams["cavlc"], dev)
        planes = recon_fused.reconstruct_frames_fused(packed, dev)
        rgb_ms = cuda_ms(lambda: yuv420_to_rgb_device(*planes), 10)
        rgb_bytes = planes[0].numel() * 3
        bound_ms = (planes[0].numel() * 3 // 2 + rgb_bytes) \
            / HBM_BYTES_PER_S * 1e3
        # the host converter on the read-back planes, one pass over the
        # batch, against the card's op plus its readback
        t = time.perf_counter()
        for p in pics:
            yuv420_to_rgb_py(p.y, p.cb, p.cr)
        host_ms = (time.perf_counter() - t) * 1e3
        with_rgb = statistics.median(
            [first["total"]] + [mv_decode_split(path, want_rgb=True)[1]
                                ["total"] for _ in range(2)])
        without = totals["cavlc", "mp4"]
        log("containers", t0, f"rgb: {len(pics)} pictures, RGB "
            f"{'=' if rgb_got == rgb_want else '!='} JAX digests, "
            f"{'=' if host_same else '!='} the numpy converter, launches "
            f"{launches} (want 1); yuv420_to_rgb_device on resident "
            f"{list(planes[0].shape)} planes {rgb_ms:.3f} ms (CUDA events), "
            f"bound {bound_ms:.4f} ms by bytes; extra readback {rgb_bytes} "
            f"bytes; host yuv420_to_rgb_py on the {len(pics)} read-back "
            f"pictures {host_ms:.1f} ms (host clock, one pass); mv_decode "
            f"{BATCH / with_rgb:.2f} pictures/s with RGB, "
            f"{BATCH / without:.2f} without (median of 3) "
            + ("ok" if good else "FAILED"))

        # the Python demuxers against the native one: equal tables, and
        # the Python tables' samples, read from the open file and parsed
        # by the native entropy parser, decode to the JAX digests
        for fmt in ("mp4", "mkv"):
            path = files["cavlc", fmt]
            native = mv_open(path)
            native_ok = native_demux(native)
            mv_close(native)
            with env(MINIVIDEO_TPU_NO_NATIVE="1"):
                python = mv_open(path)
                python_ok = mv_parse(python, audio=False, subs=False)
            try:
                equal = (native_ok and python_ok
                         and same_tracks(native, python))
                pics, launches = decode_counted(
                    lambda: mv_decode(python, picture_number=BATCH))
            finally:
                mv_close(python)
            same_pics = digests(pics) == [JAX_DIGESTS[i % 2]
                                          for i in range(BATCH)]
            good = equal and same_pics and launches == 1
            ok = ok and good
            log("containers", t0, f"{fmt}: native demux "
                f"{'ok' if native_ok else 'FAILED'}, Python demux tables "
                f"{'=' if equal else '!='} native "
                f"({native.tracks_video[0].sample_count if native_ok else 0}"
                f" samples); {len(pics)} pictures decoded from the Python "
                f"tables {'=' if same_pics else '!='} JAX digests, "
                f"launches {launches} (want 1) "
                + ("ok" if good else "FAILED"))
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


# the files phase: the scaling lists of the kernel phase's SMALL[4]
# stream on the 1080p stream, make_stream(**STREAM_KW, **SCALING_LISTS)
SCALING_LISTS = dict(scaling_lists=SMALL[4]["scaling_lists"],
                     pps_scaling_lists=SMALL[4]["pps_scaling_lists"])
SCALING_SHA256 = ("03f7bafffc195b6036eceda599219681"
                  "e3a2d2b9e2b615929b84de0ce135b04b")
# (Y, Cb, Cr) SHA-256 per picture of that stream from the JAX package's
# decode_annexb(engine="fused") with device-layout staging, on the CPU
SCALING_DIGESTS = [
    ["b0e2c57620d0cc20b5e6a64d5fd42208f28fa2a65ee0137344c9628c15e10167",
     "9ceb74a5aaa721ac449c48fa0947ee52936d1c10f2d10332d383e85ab5d0ca69",
     "1cf89a6b51b9eab6ecf512c7d5a7cb200abf56779e9a63327916b5a64592a586"],
    ["10fce1ca24343d5d6908ccf43e363cc30ac5c753b1d6bb037fc10094eb7d1243",
     "4ec9f41e8048e37322a10b8b4af9e53b43bae7920611d25613f33036a391a3f9",
     "2afec10f82dae37a1237ba680670604c04fcb8d14175c4fb3a6072aec74ffec0"],
]
# the pictures the JAX package's mv_decode(picture_number=16) returns from
# the MPEG-PS files of write_container_files: none.  A 1080p picture spans
# several PES packets; both packages' PS demuxers take each packet as a
# sample and only the packet that starts an IDR picture as a sync sample,
# so every picture selected is cut to its first packet and fails to parse
# (the AVI and ES files give JAX_DIGESTS / CABAC_DIGESTS)
PS_DIGESTS = []
# per file of write_container_files (the 16-picture 1080p batches), the
# SHA-256 of what the JAX package's extractor writes (ES and --pes, by
# file name) and of its analyser's --json output with the file's path
# replaced by its name (app_outputs, run on the JAX apps on the CPU)
APP_DIGESTS = {
    "cavlc.avi": {
        "es": {"cavlc_track0.264": "3fbd3bac4cbeda4f0d2e25a98199f6c8"
                                   "23412ad658d0d33db1f245b633d9186f"},
        "pes": {"cavlc_track0.pes": "78ae8d6374d807ffa34af5a5b33c3ca3"
                                    "a98a8bc2e128ddf9dd6600800f9585a0"},
        "json": "fb40b80fa050f1ca27e7029971f15a64"
                "e30a1a7e777adcb77e6483b0898c9c77"},
    "cavlc.mpg": {
        "es": {"cavlc_track0.264": "4cf075837d36b4edc9d34c5b3db6097b"
                                   "5958b9e31e1c4f9707f46950c0f44cbb"},
        "pes": {"cavlc_track0.pes": "26529420cb2cb8e7ae27cddd5414a6a4"
                                    "4689b7de8a97db1b9f5da2b45486fb78"},
        "json": "22e414a217b808259849f993fc73d1ad"
                "1a92e579dd56d0c856f860b5daf44a36"},
    "cabac.avi": {
        "es": {"cabac_track0.264": "3ab283c07f17e0ccf9e97424ee2c02b5"
                                   "a13fa316cf7a54b5f658f5f56ccfe36c"},
        "pes": {"cabac_track0.pes": "20925127e45316b98c994d55e1b6278a"
                                    "7366c721550e2b8e006157048f46264a"},
        "json": "dd67e7abc57f8f18cd79b37aea379ba3"
                "720dc13aa51d00e4b8dad631d21e490e"},
    "cabac.mpg": {
        "es": {"cabac_track0.264": "3287c4ef6d19142767f04b1a95af9106"
                                   "10ef41e79cd2946213ecb2fc8b8f81f3"},
        "pes": {"cabac_track0.pes": "fdd6d3105173e4fe3444d19b1dbd1127"
                                    "5c33848ebe0c2259178112c555305a84"},
        "json": "5bbf97532c68a5ffa5e6bf117375cd07"
                "6701c6149be48a13f399d4fbbc924bd9"},
}


def write_container_files(tmp, streams):
    """The 1080p CAVLC and CABAC batches of 16 as AVI, MPEG-PS and raw ES
    files in `tmp`: {(entropy, extension): path}."""
    from minivideo_tpu_torch.testing import containers as C
    writers = {"avi": lambda s: C.write_avi(s, 1920, 1088),
               "mpg": C.write_ps, "264": lambda s: s}
    files = {}
    for entropy in ("cavlc", "cabac"):
        for ext, write in writers.items():
            path = os.path.join(tmp, f"{entropy}.{ext}")
            with open(path, "wb") as f:
                f.write(write(streams[entropy]))
            files[entropy, ext] = path
    return files


def app_outputs(extractor, analyser, path):
    """SHA-256 of the outputs of the `extractor` and `analyser` apps'
    main() for the file `path`: {"es": {name: sha}, "pes": {name: sha},
    "json": sha of the analyser's --json output with `path` replaced by
    its file name}.  Raises where an app exits non-zero."""
    import contextlib
    import io
    import tempfile
    out = {}
    for mode in ("es", "pes"):
        d = tempfile.mkdtemp(dir=os.path.dirname(path))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = extractor.main(["-i", path, "-o", d]
                                + (["--pes"] if mode == "pes" else []))
        if rc != 0:
            raise RuntimeError(f"extractor {mode} exited {rc} on {path}")
        out[mode] = {}
        for written in buf.getvalue().split():
            with open(written, "rb") as f:
                out[mode][os.path.basename(written)] = \
                    hashlib.sha256(f.read()).hexdigest()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyser.main([path, "--json"])
    if rc != 0:
        raise RuntimeError(f"analyser exited {rc} on {path}")
    text = buf.getvalue().replace(path, os.path.basename(path))
    out["json"] = hashlib.sha256(text.encode()).hexdigest()
    return out


def phase_files(t0, dev, streams):
    """The 1080p batches from AVI, MPEG-PS and raw ES files through the
    user's entry points and the native demuxer, the 1080p stream with
    custom scaling lists, and the extractor and analyser apps on the
    AVI and MPEG-PS files."""
    import shutil
    import tempfile
    from minivideo_tpu_torch.api import mv_close, mv_open, mv_parse
    from minivideo_tpu_torch.apps import analyser, extractor
    from minivideo_tpu_torch.containers.native import native_demux
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import repeat_pictures
    ok = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        files = write_container_files(tmp, streams)
        for (entropy, ext), path in files.items():
            pinned = JAX_DIGESTS if entropy == "cavlc" else CABAC_DIGESTS
            want = ([pinned[i % len(pinned)] for i in range(BATCH)]
                    if ext != "mpg" else PS_DIGESTS)
            (pics, first), launches = decode_counted(
                lambda: mv_decode_split(path))
            splits = [first] + [mv_decode_split(path)[1] for _ in range(2)]
            split = {k: statistics.median(sp[k] for sp in splits)
                     for k in splits[0]}
            # the native demuxer's tables against the Python demuxers'
            native = mv_open(path)
            try:
                native_ok = native_demux(native)
                with env(MINIVIDEO_TPU_NO_NATIVE="1"):
                    python = mv_open(path)
                    try:
                        tables = (native_ok
                                  and mv_parse(python, audio=False,
                                               subs=False)
                                  and same_tracks(native, python))
                    finally:
                        mv_close(python)
            finally:
                mv_close(native)
            want_launches = 1 if want else 0
            good = (digests(pics) == want and launches == want_launches
                    and tables)
            ok = ok and good
            log("files", t0, f"{entropy} {ext} ({os.path.getsize(path)} "
                f"bytes): mv_decode {len(pics)} pictures (JAX package: "
                f"{len(want)}), planes "
                f"{'=' if digests(pics) == want else '!='} JAX digests, "
                f"wave_kernel launches {launches} (want {want_launches}), "
                f"Python demux "
                f"tables {'=' if tables else '!='} native; host clock, s, "
                f"median of 3: demux (native) {split['demux']:.4f}, stream "
                f"assembly {split['assembly']:.4f}, decode_annexb "
                f"{split['decode_annexb']:.4f}; "
                f"{BATCH / split['total']:.2f} pictures/s "
                + ("ok" if good else "FAILED"))

        # custom scaling lists at 1080p
        t = time.time()
        data = make_stream(**STREAM_KW, **SCALING_LISTS)
        digest = hashlib.sha256(data).hexdigest()
        encode_s = time.time() - t
        stream = repeat_pictures(data, BATCH // 2)
        t = time.time()
        pics, launches = decode_counted(lambda: decode_annexb(stream))
        decode_s = time.time() - t
        want = [SCALING_DIGESTS[i % len(SCALING_DIGESTS)]
                for i in range(BATCH)]
        good = (digest == SCALING_SHA256 and digests(pics) == want
                and launches == 1 and pics[0].y.shape == (1088, 1920))
        ok = ok and good
        log("files", t0, f"1080p scaling lists x2 encoded in {encode_s:.2f}s"
            f", sha256 {'=' if digest == SCALING_SHA256 else '!='} pinned; "
            f"decode_annexb {len(pics)} pictures in {decode_s:.3f}s, planes "
            f"{'=' if digests(pics) == want else '!='} SCALING_DIGESTS, "
            f"wave_kernel launches {launches} (want 1) "
            + ("ok" if good else "FAILED"))

        # the extractor and analyser apps on the AVI and MPEG-PS files
        for key in [k for k in files if k[1] != "264"]:
            name = os.path.basename(files[key])
            t = time.perf_counter()
            got = app_outputs(extractor, analyser, files[key])
            apps_s = time.perf_counter() - t
            good = got == APP_DIGESTS[name]
            ok = ok and good
            log("files", t0, f"{name}: extractor ES "
                f"{sorted(got['es'])}, PES {sorted(got['pes'])}, analyser "
                f"--json: {'=' if good else '!='} the JAX apps' pins "
                f"({apps_s:.3f}s, host clock) "
                + ("ok" if good else f"FAILED: {got}"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


# small streams for the Python parsers: 8x8 transforms, I_PCM, 3 slices
PARSER_STREAMS = {
    "cavlc": dict(width_mbs=6, height_mbs=4, n_pictures=2, seed=21,
                  profile=100, transform_8x8=True,
                  mb_kinds=("i16", "i4", "i8"), n_slices=3, allow_pcm=True),
    "cabac": dict(width_mbs=6, height_mbs=4, n_pictures=2, seed=22,
                  entropy="cabac", transform_8x8=True,
                  mb_kinds=("i16", "i4", "i8"), n_slices=3, allow_pcm=True),
}


def phase_parsers(t0, dev, streams):
    """MINIVIDEO_TPU_NO_NATIVE=1 decodes equal the native parse's."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    ok = True
    for name, kw in PARSER_STREAMS.items():
        data = (make_stream2 if name == "cabac" else make_stream)(**kw)
        native = digests(decode_annexb(data))
        with env(MINIVIDEO_TPU_NO_NATIVE="1"):
            pics, launches = decode_counted(lambda: decode_annexb(data))
        good = (digests(pics) == native and launches == 1
                and len(pics) == kw["n_pictures"])
        ok = ok and good
        log("parsers", t0, f"{name}: Python parser {len(pics)} pictures, "
            f"planes {'=' if digests(pics) == native else '!='} native "
            f"parse's, launches {launches} (want 1) "
            + ("ok" if good else "FAILED"))
    return ok


def phase_bad_slices(t0, dev, streams):
    """Streams with bad IDR pictures give the JAX package's pictures."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import BAD_STREAMS, bad_stream
    ok = True
    for name in BAD_STREAMS:
        data = bad_stream(name, make_stream)
        pics, launches = decode_counted(lambda: decode_annexb(data))
        got = digests(pics)
        good = got == BAD_DIGESTS[name] and launches == 1
        ok = ok and good
        log("bad slices", t0, f"{name}: {len(pics)} pictures (JAX package: "
            f"{len(BAD_DIGESTS[name])}), planes "
            f"{'=' if got == BAD_DIGESTS[name] else '!='} JAX digests, "
            f"launches {launches} (want 1) " + ("ok" if good else "FAILED"))
    return ok


# the thumbnails phase's small clips (4x3 MBs, one picture each): one
# clean, one whose slice data is spoiled after its headers; both share a
# bucket, apart from the 1080p clips' bucket
THUMB_SMALL_KW = dict(width_mbs=4, height_mbs=3, n_pictures=1, seed=31,
                      profile=100, transform_8x8=True,
                      mb_kinds=("i16", "i4", "i8"))
THUMB_BAD_SEED = 32
# SHA-256 of the JAX package's native JPEG (quality 75) of each 1080p
# CAVLC picture, of the (Y, Cb, Cr) of the small clip's picture from its
# decode_annexb(engine="fused"), and of the JAX package's mv_extract of
# the video track of write_mp4(<the 16-picture CAVLC batch>) to ES
JPEG_DIGESTS = [
    "11d58ab347018e685a4eb79e65b8f0e511857702fceddf628d675becb8d8930a",
    "a1b013532bd4e70639c40ddb32055798c82b413e5de92fbf12a9ec5d2cb75c3f",
]
SMALL_DIGESTS = [
    "56606e3ab88eeb42b1458a6b82310455fd5f7dc33dcff3ccca8e8726e6d90978",
    "21aec9f7ae6293c515076cd5f5b759195c5d224ff8dd8dd20802a87d8d18396f",
    "d6be7e1faf4e05c82e814dd615cf4c72f98198acf89fa9fb969931ccde3f4558",
]
ES_SHA256 = ("3fbd3bac4cbeda4f0d2e25a98199f6c8"
             "23412ad658d0d33db1f245b633d9186f")


def spoil(data):
    """`data` with every third byte of its last third flipped: the
    headers parse, the slice data does not (tests/test_parallel.py)."""
    out = bytearray(data)
    for pos in range(len(out) * 2 // 3, len(out) - 8, 3):
        out[pos] ^= 0xFF
    return bytes(out)


def picture_stream(data, k):
    """The Annex-B stream `data` (one slice per picture) with its IDR
    access unit k alone: parameter sets, that picture, trailing NALUs."""
    from minivideo_tpu_torch.models.h264.nalu import split_annexb
    units = [raw for _, raw in split_annexb(data)]
    idr = [i for i, u in enumerate(units) if u[0] & 0x1F == 5]
    keep = units[:idr[0]] + [units[idr[k]]] + units[idr[-1] + 1:]
    return b"".join(b"\x00\x00\x00\x01" + u for u in keep)


def png_pixels(path):
    """RGB8 pixels [H, W, 3] of a PNG file, inflated with zlib and
    unfiltered in numpy (filter types None, Sub and Up: the ones the
    writers use; no interlace)."""
    import struct
    import zlib
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)),
                        np.uint8).reshape(h, 1 + 3 * w)
    out = np.empty((h, 3 * w), np.uint8)
    prev = np.zeros(3 * w, np.uint8)
    for r in range(h):
        kind, row = raw[r, 0], raw[r, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:         # Sub: add the pixel to the left, mod 256
            cur = np.cumsum(row.reshape(w, 3), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:         # Up
            cur = row + prev
        else:
            raise ValueError(f"{path}: PNG filter {kind} not supported")
        out[r] = cur
        prev = out[r]
    return out.reshape(h, w, 3)


def yuv_planes(path, h, w):
    """(Y, Cb, Cr) of a planar 4:2:0 file of h x w luma."""
    import numpy as np
    raw = np.fromfile(path, np.uint8)
    if raw.size != h * w * 3 // 2:
        raise ValueError(f"{path}: {raw.size} bytes, not {h}x{w} 4:2:0")
    c = h * w // 4
    return (raw[:h * w].reshape(h, w),
            raw[h * w:h * w + c].reshape(h // 2, w // 2),
            raw[h * w + c:].reshape(h // 2, w // 2))


def batch_run(clips, outdir, fmt, **kw):
    """batch_thumbnail on the card: (BatchResult, its StageTimer, host
    seconds of the call, the _Recon calls as [(PackedFrames, planes)]).
    batch_thumbnail imports StageTimer from profiling at each call, so
    the class is wrapped there to read its stages, and _Recon's call to
    keep the buckets' staging and planes."""
    from minivideo_tpu_torch import profiling
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch
    real_timer, real_recon = profiling.StageTimer, batch._Recon.__call__
    timers, recons = [], []

    class Timer(real_timer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    def recon(self, packed, **k):
        out = real_recon(self, packed, **k)
        recons.append((packed, out[:3]))
        return out

    profiling.StageTimer, batch._Recon.__call__ = Timer, recon
    try:
        t = time.perf_counter()
        res = batch.batch_thumbnail(clips, outdir,
                                    fmt=PictureFormat[fmt], **kw)
        secs = time.perf_counter() - t
    finally:
        profiling.StageTimer, batch._Recon.__call__ = real_timer, real_recon
    return res, timers[0], secs, recons


def write_thumbnail_clips(tmp, streams):
    """The thumbnails phase's files in `tmp`: the two 1080p CAVLC
    pictures alternating in 8 MP4, 4 Matroska and 4 MPEG-TS files, the
    CABAC batch's first picture in an MP4, the small clip and the
    corrupt one.  Returns (clips, {clip: (plane digests, RGB digest or
    None, JPEG digest or None)} for every clip but the corrupt one)."""
    from minivideo_tpu_torch.testing import containers as C
    from minivideo_tpu_torch.testing.h264enc import make_stream
    h, w = 16 * STREAM_KW["height_mbs"], 16 * STREAM_KW["width_mbs"]
    files, want = [], {}
    writers = [("mp4", lambda s: C.write_mp4(s, w, h))] * 8 + \
        [("mkv", lambda s: C.write_mkv(s, w, h))] * 4 + \
        [("ts", C.write_ts)] * 4
    # the 1080p batches' first two access units are the two pictures
    for i, (ext, write) in enumerate(writers):
        name = f"cavlc{i:02d}.{ext}"
        files.append((name, write(picture_stream(streams["cavlc"], i % 2))))
        want[name] = (JAX_DIGESTS[i % 2], RGB_DIGESTS[i % 2],
                      JPEG_DIGESTS[i % 2])
    files.append(("cabac.mp4", C.write_mp4(
        picture_stream(streams["cabac"], 0), w, h)))
    want["cabac.mp4"] = (CABAC_DIGESTS[0], None, None)
    files.append(("small.264", make_stream(**THUMB_SMALL_KW)))
    want["small.264"] = (SMALL_DIGESTS, None, None)
    files.append(("corrupt.264", spoil(make_stream(
        **dict(THUMB_SMALL_KW, seed=THUMB_BAD_SEED)))))
    clips = []
    for name, data in files:
        clips.append(os.path.join(tmp, name))
        with open(clips[-1], "wb") as f:
            f.write(data)
    return clips, {os.path.join(tmp, k): v for k, v in want.items()}


def thumbnail_files_ok(fmt, res, want, planes):
    """Whether every good clip's file holds its pinned digest: YUV420
    planes (kept in `planes` for the later formats), PNG pixels, JPEG
    bytes.  The CABAC and small clips have no pinned RGB or JPEG: theirs
    must equal the host converter's and the native JPEG of their
    YUV420 planes.  Returns (ok, bytes written)."""
    import numpy as np
    from minivideo_tpu_torch import native
    from minivideo_tpu_torch.export.image import yuv420_to_rgb_py
    outs = {os.path.splitext(os.path.basename(o))[0]: o
            for o in res.outputs}
    ok, nbytes = True, 0
    for clip, (digest, rgb_digest, jpeg_digest) in want.items():
        o = outs.get(os.path.splitext(os.path.basename(clip))[0])
        if o is None:
            ok = False
            continue
        nbytes += os.path.getsize(o)
        if fmt == "YUV420":
            small = clip.endswith("small.264")
            kw = THUMB_SMALL_KW if small else STREAM_KW
            planes[clip] = yuv_planes(o, 16 * kw["height_mbs"],
                                      16 * kw["width_mbs"])
            ok = ok and [sha(p) for p in planes[clip]] == digest
        elif fmt == "PNG":
            px = png_pixels(o)
            ok = ok and (sha(px) == rgb_digest if rgb_digest else
                         np.array_equal(px, yuv420_to_rgb_py(*planes[clip])))
        else:
            with open(o, "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
            ok = ok and got == (jpeg_digest or hashlib.sha256(
                native.encode_jpeg_native(*planes[clip], 75)).hexdigest())
    return ok, nbytes


def small_bucket_check(recons, dev):
    """The small bucket of a batch_thumbnail run: its rows that came out
    all black, and the wave kernel against its plain version on its
    staging on the card (max |err|)."""
    from minivideo_tpu_torch.ops import recon_fused
    packed, planes = next((pk, pl) for pk, pl in recons
                          if pk.wmb == THUMB_SMALL_KW["width_mbs"])
    black = [i for i in range(planes[0].shape[0])
             if not any(p[i].any() for p in planes)]
    pk = recon_fused.to_device(packed, dev)
    if pk.slots == 2:
        arrs = [pk.arrays[k] for k in recon_fused.DEVICE_STAGING]
    else:
        arrs = recon_fused.records_feeds(pk.arrays, *pk.chroma_qp_off,
                                         pk.wmb, pk.hmb, pk.batch)
    return black, compare_kernel(pk, arrs)[0]


def thumbnail_host_costs(t0, dev, streams):
    """RGB of the 16 read-back 1080p pictures on the card (op plus its
    readback) against the native host converter, and PNG encoding as the
    export pool runs it against one band per picture and one worker.
    Returns whether the card's RGB equals the host converter's."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from minivideo_tpu_torch import native
    from minivideo_tpu_torch.export.image import yuv420_to_rgb
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.ops.color import yuv420_to_rgb_device
    packed, _, _ = staged(streams["cavlc"], dev)
    dplanes = recon_fused.reconstruct_frames_fused(packed, dev)
    host = [p.cpu().numpy() for p in dplanes]

    def card_rgb():
        return yuv420_to_rgb_device(*dplanes).cpu()

    def host_rgb():
        return [yuv420_to_rgb(host[0][i], host[1][i], host[2][i])
                for i in range(BATCH)]

    rgbs = host_rgb()
    same = all(np.array_equal(a.numpy(), b)
               for a, b in zip(card_rgb(), rgbs))
    card_s, host_s = median_s(card_rgb), median_s(host_rgb)
    readback_s = median_s(lambda: [p.cpu() for p in dplanes])
    log("thumbnails", t0, f"RGB of {BATCH} read-back 1080p pictures: card "
        f"op + its readback ({dplanes[0].numel() * 3} bytes) "
        f"{card_s * 1e3:.1f} ms, native host converter (export.cc, one "
        f"thread) {host_s * 1e3:.1f} ms, planes' readback alone "
        f"{readback_s * 1e3:.1f} ms (host clock, median of 3); RGB "
        f"{'=' if same else '!='} " + ("ok" if same else "FAILED"))

    # batch_thumbnail's export pool: 8 workers, each deflating one band
    # per hardware thread (encode_png_native(threads=0))
    def png_all(workers, threads):
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda r: native.encode_png_native(r, 3, threads),
                        rgbs))

    png_s = {(wk, th): median_s(lambda: png_all(wk, th))
             for wk, th in ((8, 0), (8, 1), (1, 0))}
    log("thumbnails", t0, f"native PNG of the {BATCH} pictures (host clock, "
        f"s, median of 3; threads=0 is one band per hardware thread, "
        f"{os.cpu_count()} here): "
        + ", ".join(f"{wk} workers x threads={th} {v:.4f}"
                    for (wk, th), v in png_s.items()))
    return same


def thumbnail_cli_and_extract(t0, tmp, streams):
    """The thumbnailer CLI (-n 16 -f png) on the 16-picture CAVLC MP4,
    then mv_extract of its video track to ES, decoded on the card."""
    import contextlib
    import io
    from minivideo_tpu_torch.api import mv_close, mv_extract, mv_open, mv_parse
    from minivideo_tpu_torch.apps import thumbnailer
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.testing import containers as C
    h, w = 16 * STREAM_KW["height_mbs"], 16 * STREAM_KW["width_mbs"]
    mp4 = os.path.join(tmp, "cavlc16.mp4")
    with open(mp4, "wb") as f:
        f.write(C.write_mp4(streams["cavlc"], w, h))
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        (rc, launches) = decode_counted(lambda: thumbnailer.main(
            ["-i", mp4, "-o", os.path.join(tmp, "cli"), "-n", "16",
             "-f", "png"]))
    cli_s = time.perf_counter() - t
    files = buf.getvalue().split()
    pixels_ok = [sha(png_pixels(p)) for p in files] == \
        [RGB_DIGESTS[i % 2] for i in range(BATCH)]
    ok = rc == 0 and launches == 1 and pixels_ok
    log("thumbnails", t0, f"thumbnailer -n 16 -f png: exit {rc}, "
        f"{len(files)} files in {cli_s:.3f} s (host clock, one run), "
        f"pixels {'=' if pixels_ok else '!='} RGB_DIGESTS, launches "
        f"{launches} (want 1) " + ("ok" if ok else "FAILED"))

    media = mv_open(mp4)
    try:
        if not mv_parse(media, audio=False, subs=False):
            raise RuntimeError(f"mv_parse failed on {mp4}")
        es = mv_extract(media, media.tracks_video[0], tmp, "es")
    finally:
        mv_close(media)
    with open(es, "rb") as f:
        es_data = f.read()
    es_ok = hashlib.sha256(es_data).hexdigest() == ES_SHA256
    pics, launches = decode_counted(lambda: decode_annexb(es_data))
    pics_ok = digests(pics) == [JAX_DIGESTS[i % 2] for i in range(BATCH)]
    good = es_ok and pics_ok and launches == 1
    log("thumbnails", t0, f"mv_extract to ES: {os.path.basename(es)} "
        f"{len(es_data)} bytes, sha256 {'=' if es_ok else '!='} pinned; "
        f"decoded {len(pics)} pictures {'=' if pics_ok else '!='} JAX "
        f"digests, launches {launches} (want 1) "
        + ("ok" if good else "FAILED"))
    return ok and good


def phase_thumbnails(t0, dev, streams):
    """Thumbnails from 1080p files on the card: batch_thumbnail over 16
    CAVLC files (MP4, Matroska, MPEG-TS), the CABAC MP4 and two small
    clips, one of them corrupt, per format (YUV420, PNG, JPG: checked on
    the first of 3 timed runs, YUV420's then resumed); the host costs
    of RGB and PNG; the thumbnailer CLI; mv_extract."""
    import shutil
    import tempfile
    from minivideo_tpu_torch.ops import recon_fused
    ok = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_thumbs_")
    try:
        clips, want = write_thumbnail_clips(tmp, streams)
        bad, n_good = clips[-1], len(clips) - 1
        runs, planes = {}, {}
        for fmt in ("YUV420", "PNG", "JPG"):
            runs[fmt] = []
            for rep in range(3):
                out = os.path.join(tmp, f"{fmt}{rep}")
                (res, timer, secs, recons), launches = decode_counted(
                    lambda: batch_run(clips, out, fmt))
                runs[fmt].append((timer, secs, launches))
                if rep:
                    shutil.rmtree(out)
                    continue
                files_ok, nbytes = thumbnail_files_ok(fmt, res, want,
                                                      planes)
                black, err_small = small_bucket_check(recons, dev)
                good = (files_ok and res.done == n_good and res.failed == 1
                        and res.skipped == 0 and launches == 2
                        and list(res.errors) == [bad] and black == [1]
                        and err_small == 0)
                ok = ok and good
                log("thumbnails", t0, f"batch_thumbnail {fmt}: "
                    f"{res.done} done, {res.failed} failed "
                    f"({[os.path.basename(p) for p in res.errors]}), "
                    f"{res.frames} frames, {len(res.outputs)} files "
                    f"({nbytes} bytes), every file "
                    f"{'=' if files_ok else '!='} its pinned digest, "
                    f"wave_kernel launches {launches} (want 2, one per "
                    f"bucket); small bucket: black rows {black} (want [1], "
                    f"the corrupt clip), kernel vs plain max|err| "
                    f"{err_small} " + ("ok" if good else "FAILED"))
                if fmt == "YUV420":
                    # a second call on the same directory skips every done
                    # clip and retries the corrupt one
                    (again, _, _, _), launches = decode_counted(
                        lambda: batch_run(clips, out, fmt))
                    good = (again.skipped == n_good and again.done == 0
                            and again.failed == 1)
                    ok = ok and good
                    log("thumbnails", t0, f"resume: skipped "
                        f"{again.skipped} (want {n_good}), done "
                        f"{again.done}, failed {again.failed}, launches "
                        f"{launches} " + ("ok" if good else "FAILED"))
        for fmt, rs in runs.items():
            stages = {k: statistics.median(r[0].acc[k] for r in rs)
                      for k in rs[0][0].acc}
            wall = statistics.median(r[1] for r in rs)
            log("thumbnails", t0, f"{fmt} timing (host clock, s, median of "
                f"3 batches of {len(clips)} clips, {n_good} thumbnails): "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                + f"; batch_thumbnail {wall:.4f} s, "
                f"{n_good / wall:.2f} thumbnails/s; launches per batch "
                f"{[r[2] for r in rs]}")
        ok = thumbnail_host_costs(t0, dev, streams) and ok
        ok = thumbnail_cli_and_extract(t0, tmp, streams) and ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


def device_work(fn):
    """(fn()'s result, {kind: count} of the device activity of that call
    from torch.profiler's trace: "kernel" launches, "memcpy", "memset",
    and "busy_ms", the sum of their durations).  fn runs once, inside the
    trace, and its exceptions propagate; only a failure of the profiler
    itself (starting, stopping, reading the trace) or a trace with no
    device events gives "not measured (...)" in place of the counts."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof, why = None, None
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:                    # noqa: BLE001 - a diagnostic
        prof, why = None, e
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception as e:            # noqa: BLE001 - a diagnostic
                prof, why = None, e
    if prof is None:
        return out, f"not measured ({type(why).__name__}: {why})"
    try:
        kinds, busy_ns = collections.Counter(), 0
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                name = e.name()
                kinds["memcpy" if name.startswith("Memcpy") else
                      "memset" if name.startswith("Memset") else
                      "kernel"] += 1
                busy_ns += e.duration_ns()
    except Exception as e:                    # noqa: BLE001 - a diagnostic
        return out, f"not measured ({type(e).__name__}: {e})"
    if not kinds:
        return out, "not measured (no device events)"
    return out, dict(kinds, busy_ms=round(busy_ns / 1e6, 3))


def plane_digests(planes):
    """digests() of (Y, Cb, Cr) batch tensors, per picture."""
    y, cb, cr = (p.cpu().numpy() for p in planes)
    return [[sha(y[i]), sha(cb[i]), sha(cr[i])] for i in range(len(y))]


def raster_staged(stream, device):
    """The one-part stream's raster staging on `device` (the wave and
    lane engines' feed)."""
    from minivideo_tpu_torch.models.h264.decoder import stage_annexb
    (_, packed), = stage_annexb(stream, device, staging_mode="raster")
    return packed


def peak_run(fn):
    """(fn()'s result, host seconds to the end of its device work, peak
    device memory above what was allocated before, that base)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.time() - t, torch.cuda.max_memory_allocated() - base,
            base)


def phase_engines(t0, dev, streams):
    """The wave, lane and np engines on the card (see the docstring's
    phase 14).  Returns whether every check held."""
    import shutil
    import tempfile
    import torch
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.ops.recon import build_residuals
    from minivideo_tpu_torch.ops.recon_lane import reconstruct_frames_lane
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import BAD_STREAMS, bad_stream
    ok = True
    wants = {"cavlc": [JAX_DIGESTS[i % 2] for i in range(BATCH)],
             "cabac": [CABAC_DIGESTS[i % 2] for i in range(BATCH)]}

    # ---- decode_annexb(engine="wave"): where its planes were computed;
    # the CAVLC batch timed three times (each run's digests and peak
    # memory checked), the CABAC batch's device work traced
    spied = []
    real = tdec.reconstruct_frames_wave

    def spy(packed, device=None):
        out = real(packed, device)
        spied.append(out[0].device.type)
        return out

    tdec.reconstruct_frames_wave = spy
    try:
        for name in ("cavlc", "cabac"):
            spied.clear()

            def wave(name=name):
                return tdec.decode_annexb(streams[name], engine="wave")

            if name == "cavlc":
                runs, launches = decode_counted(
                    lambda: [peak_run(wave) for _ in range(3)])
                got = [digests(r[0]) for r in runs]
                same = all(g == wants[name] for g in got)
                n_pics = len(runs[0][0])
                secs = [r[1] for r in runs]
                e2e = statistics.median(secs)
                msg = (f"runs of {[round(x, 3) for x in secs]} s, "
                       f"{e2e:.3f} s per batch, {BATCH / e2e:.2f} "
                       f"pictures/s (median of 3); peak memory "
                       f"{max(r[2] for r in runs)} bytes above "
                       f"{runs[0][3]}")
                where_ok = spied == ["cuda"] * 3
            else:
                t = time.time()
                (pics, kinds), launches = decode_counted(
                    lambda: device_work(wave))
                same = digests(pics) == wants[name]
                n_pics = len(pics)
                msg = (f"{time.time() - t:.3f} s (traced); device activity "
                       f"of the batch (torch.profiler): {kinds}")
                where_ok = spied == ["cuda"]
            good = same and launches == 0 and where_ok
            ok = ok and good
            log("engines", t0, f"decode_annexb(engine='wave') {name}: "
                f"{n_pics} pictures, planes computed on {list(spied)}, "
                f"{'=' if same else '!='} JAX digests, wave_kernel "
                f"launches {launches} (want 0); {msg} "
                + ("ok" if good else "FAILED"))
    finally:
        tdec.reconstruct_frames_wave = real

    # ---- the lane loop on the raster batch (one run; its launches are
    # the traced CABAC wave decode's, which runs the same loop), and
    # build_residuals
    packed = raster_staged(streams["cavlc"], dev)
    (planes, secs, peak, base), launches = decode_counted(
        lambda: peak_run(lambda: reconstruct_frames_lane(packed)))
    on_card = all(p.device.type == "cuda" for p in planes)
    got = plane_digests(planes)
    del planes
    good = got == wants["cavlc"] and on_card and launches == 0
    ok = ok and good
    log("engines", t0, f"reconstruct_frames_lane: 1080p raster batch of "
        f"{BATCH} in {secs:.3f}s ({BATCH / secs:.2f} pictures/s, one run), "
        f"planes on {'cuda' if on_card else 'NOT cuda'} "
        f"{'=' if got == wants['cavlc'] else '!='} JAX digests, wave_kernel "
        f"launches {launches} (want 0); peak memory {peak} bytes above "
        f"{base} " + ("ok" if good else "FAILED"))

    def residuals(p):
        return build_residuals(p.arrays, p.ls4, p.ls8, *p.chroma_qp_off)

    cpu = raster_staged(streams["cavlc"], "cpu")
    t = time.time()
    want = residuals(cpu)
    cpu_s = time.time() - t
    got = residuals(packed)
    same = all(torch.equal(got[k].cpu(), want[k]) for k in want)
    del got, want
    res_ms = cuda_ms(lambda: residuals(packed), 5)
    ok = ok and same
    log("engines", t0, f"build_residuals of the 1080p raster batch of "
        f"{BATCH}: card {'=' if same else '!='} CPU; {res_ms:.3f} ms on "
        f"the card (CUDA events, median of 3 x 5 calls), {cpu_s:.3f} s on "
        f"the host's CPU (one run) " + ("ok" if same else "FAILED"))
    del packed, cpu

    # ---- np: the numpy oracle on the host
    t = time.time()
    pics = tdec.decode_annexb(streams["cavlc"], engine="np", max_pictures=2)
    np_s = (time.time() - t) / 2
    good = digests(pics) == JAX_DIGESTS and all(p.rgb is None for p in pics)
    ok = ok and good
    log("engines", t0, f"decode_annexb(engine='np', max_pictures=2): "
        f"{len(pics)} pictures, {'=' if good else '!='} the first two JAX "
        f"digests; {np_s:.3f} s per 1080p picture on the host "
        + ("ok" if good else "FAILED"))

    # ---- small feature streams: wave (card) = fused (card) = np
    bad = []
    for kw in SMALL:
        data = make_stream(**kw)
        outs = [digests(tdec.decode_annexb(data, engine=e))
                for e in ("wave", "fused", "np")]
        if not outs[0] == outs[1] == outs[2]:
            bad.append(kw["seed"])
    ok = ok and not bad
    log("engines", t0, f"{len(SMALL)} small streams of the kernel phase: "
        f"wave = fused = np on all but seeds {bad} "
        + ("ok" if not bad else "FAILED"))

    # ---- BAD_STREAMS through wave and np
    for name in BAD_STREAMS:
        data = bad_stream(name, make_stream)
        got = {e: digests(tdec.decode_annexb(data, engine=e))
               for e in ("wave", "np")}
        good = all(g == BAD_DIGESTS[name] for g in got.values())
        ok = ok and good
        log("engines", t0, f"bad stream {name}: wave {len(got['wave'])}, "
            f"np {len(got['np'])} pictures (JAX package: "
            f"{len(BAD_DIGESTS[name])}), both {'=' if good else '!='} "
            f"BAD_DIGESTS " + ("ok" if good else "FAILED"))

    # ---- batch_thumbnail(engine="wave") over the 16 CAVLC 1080p files
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engines_")
    try:
        clips, want = write_thumbnail_clips(tmp, streams)
        clips = [c for c in clips if os.path.basename(c).startswith("cavlc")]
        want = {c: want[c] for c in clips}
        out = os.path.join(tmp, "wave")
        (res, timer, secs, _), launches = decode_counted(
            lambda: batch_run(clips, out, "YUV420", engine="wave"))
        files_ok, _ = thumbnail_files_ok("YUV420", res, want, {})
        good = (files_ok and res.done == len(clips) and res.failed == 0
                and launches == 0)
        ok = ok and good
        log("engines", t0, f"batch_thumbnail(engine='wave', YUV420) over "
            f"{len(clips)} CAVLC 1080p files: {res.done} done, "
            f"{res.failed} failed, every file "
            f"{'=' if files_ok else '!='} its JAX digest, wave_kernel "
            f"launches {launches} (want 0); {secs:.3f}s, stages "
            + ", ".join(f"{k} {v:.4f}" for k, v in timer.acc.items())
            + (" ok" if good else " FAILED"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


def card_mesh(dev, n, axis=None):
    """A mesh of n entries that all name `dev`: 2 x 2 ("data", "seq")
    by make_mesh, or one axis named `axis`."""
    from minivideo_tpu_torch.parallel.sharding import Mesh, make_mesh
    if axis is None:
        return make_mesh(devices=[dev] * n)
    import numpy as np
    devs = np.empty(n, dtype=object)
    devs[:] = [dev] * n
    return Mesh(devs, (axis,))


def scaleout_mesh(t0, dev, streams):
    """(a) batch_thumbnail over a 2x2 mesh of the card: the thumbnails
    phase's 19 files as YUV420 and PNG, pinned digests, 4 launches per
    bucket."""
    import shutil
    import tempfile
    ok = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        clips, want = write_thumbnail_clips(tmp, streams)
        bad, n_good = clips[-1], len(clips) - 1
        mesh = card_mesh(dev, 4)
        planes = {}
        for fmt in ("YUV420", "PNG"):
            runs = []
            for rep in range(3):
                out = os.path.join(tmp, f"{fmt}{rep}")
                (res, timer, secs, recons), launches = decode_counted(
                    lambda: batch_run(clips, out, fmt, mesh=mesh))
                runs.append((timer, secs, launches))
                if rep:
                    continue
                files_ok, nbytes = thumbnail_files_ok(fmt, res, want,
                                                      planes)
                black, err_small = small_bucket_check(recons, dev)
                good = (files_ok and res.done == n_good
                        and res.failed == 1 and list(res.errors) == [bad]
                        and launches == 8 and len(recons) == 2
                        and black == [1] and err_small == 0)
                ok = ok and good
                log("scaleout", t0, f"batch_thumbnail {fmt} over a "
                    f"{mesh.shape['data']}x{mesh.shape['seq']} mesh of "
                    f"{dev}: {res.done} done, {res.failed} failed, "
                    f"{len(res.outputs)} files ({nbytes} bytes), every file "
                    f"{'=' if files_ok else '!='} its pinned digest, "
                    f"wave_kernel launches {launches} (want 8: 4 mesh "
                    f"entries x {len(recons)} buckets); small bucket black "
                    f"rows {black}, kernel vs plain max|err| {err_small} "
                    + ("ok" if good else "FAILED"))
            stages = {k: statistics.median(r[0].acc[k] for r in runs)
                      for k in runs[0][0].acc}
            wall = statistics.median(r[1] for r in runs)
            ok = ok and all(r[2] == 8 for r in runs)
            log("scaleout", t0, f"{fmt} over the mesh, timing (host clock, "
                f"s, median of 3 batches of {len(clips)} clips): "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                + f"; batch_thumbnail {wall:.4f} s, {n_good / wall:.2f} "
                f"thumbnails/s; launches per batch {[r[2] for r in runs]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


# the halo's small stream: maxw 4, batch 2 -> 8 lanes over 4 strips, the
# frame-segment boundary on a strip boundary (tests/test_halo.py's)
HALO_SMALL_KW = dict(width_mbs=6, height_mbs=5, n_pictures=2, seed=60,
                     mb_kinds=("i16", "i4"), density=0.35, allow_pcm=True)


def scaleout_halo(t0, dev, streams):
    """(b) The halo in one process: the 1080p CAVLC and CABAC pairs over
    2 strips of the card (the JAX digests; the CABAC run traced), and a
    small stream over 4 strips (the fused engine's and np's planes)."""
    import torch
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.ops.recon_wave import skew_tables
    from minivideo_tpu_torch.parallel.halo import reconstruct_frames_halo
    from minivideo_tpu_torch.testing.h264enc import make_stream
    ok = True
    for name, want in (("cavlc2", JAX_DIGESTS), ("cabac2", CABAC_DIGESTS)):
        packed, _, _ = staged(streams[name], dev)
        mesh = card_mesh(dev, 2, "lanes")

        def run(packed=packed, mesh=mesh):
            return reconstruct_frames_halo(packed, mesh)

        t = time.time()
        if name == "cabac2":
            (planes, kinds), launches = decode_counted(
                lambda: device_work(run))
            what = f"traced; device activity (torch.profiler): {kinds}"
        else:
            planes, launches = decode_counted(run)
            torch.cuda.synchronize()
            what = "untraced"
        secs = time.time() - t
        on_card = all(p.device.type == "cuda" for p in planes)
        same = plane_digests(planes) == want
        good = same and on_card and launches == 0
        ok = ok and good
        lanes = packed.batch * skew_tables(packed.wmb, packed.hmb)["maxw"]
        log("scaleout", t0, f"halo {name[:-1]} 1080p pair (batch 2, lane "
            f"axis {lanes} over 2 strips of {dev}): planes "
            f"{'=' if same else '!='} the JAX digests, wave_kernel "
            f"launches {launches} (want 0); {secs:.3f} s ({what}) "
            + ("ok" if good else "FAILED"))
    data = make_stream(**HALO_SMALL_KW)
    packed, _, _ = staged(data, dev)
    t = time.time()
    got = plane_digests(reconstruct_frames_halo(
        packed, card_mesh(dev, 4, "lanes")))
    secs = time.time() - t
    fused = digests(decode_annexb(data))
    np_ = digests(decode_annexb(data, engine="np"))
    good = got == fused == np_
    ok = ok and good
    log("scaleout", t0, f"halo {HALO_SMALL_KW['width_mbs']}x"
        f"{HALO_SMALL_KW['height_mbs']} MBs x2 (8 lanes over 4 strips, the "
        f"frame boundary on a strip boundary): planes "
        f"{'=' if good else '!='} the fused kernel's and np's; {secs:.3f} s "
        + ("ok" if good else "FAILED"))
    return ok


def scaleout_multihost(t0, dev, streams):
    """(c) run_multihost_dryrun: 2 processes on the card, 2 mesh entries
    each, over 4 1080p CAVLC clip files; phase A 2 launches per process,
    the count reduce 4, phase B's 1080p halo across both processes; the
    saved planes give the JAX digests."""
    import re
    import shutil
    import tempfile
    import numpy as np
    from minivideo_tpu_torch.parallel.multihost import run_multihost_dryrun
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    try:
        files = []
        for i in range(4):
            files.append(os.path.join(tmp, f"clip{i}.264"))
            with open(files[-1], "wb") as f:
                f.write(picture_stream(streams["cavlc"], i % 2))
        t = time.time()
        try:
            out = run_multihost_dryrun(nprocs=2, devices_per_proc=2,
                                       timeout=600, clip_files=files,
                                       out_dir=tmp)
            err = None
        except RuntimeError as e:
            out, err = str(e), e
        secs = time.time() - t
        for line in out.splitlines():
            if line.startswith("mh["):
                log("scaleout", t0, "multihost " + line)
        ok = err is None
        for pid in range(2 if ok else 0):
            z = np.load(os.path.join(tmp, f"mh_planes.{pid}.npz"))

            def pics(ph, n):
                return [[sha(z[f"{ph}_{k}"][i]) for k in ("y", "cb", "cr")]
                        for i in range(n)]

            n_b = z["b_y"].shape[0]
            ok = (ok and n_b == 4
                  and pics("a", len(z["a_clips"]))
                  == [JAX_DIGESTS[c % 2] for c in z["a_clips"]]
                  and pics("b", n_b) == [JAX_DIGESTS[i % 2]
                                         for i in range(n_b)])
        counts = re.findall(r"wave_kernel launches (\d+)", out)
        backends = re.findall(r"backend (\w+)", out)
        ok = (ok and counts == ["2", "2"] and len(backends) == 2
              and out.count("reduce across processes = 4") == 2
              and out.count("phase B OK") == 2)
        log("scaleout", t0, f"run_multihost_dryrun: 2 processes x 2 mesh "
            f"entries of the card, backend {backends}, phase A launches "
            f"{counts} (want 2 per process), phase A and B planes "
            f"{'=' if ok else '!='} the JAX digests in both processes; "
            f"{secs:.3f} s with the workers' start "
            + ("ok" if ok else f"FAILED {str(err)[-2000:] if err else ''}"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ok


def phase_scaleout(t0, dev, streams):
    """Scale-out on the card (see the docstring's phase 15).  Returns
    whether every check held."""
    ok = True
    for part in (scaleout_mesh, scaleout_halo, scaleout_multihost):
        t = time.time()
        good = part(t0, dev, streams)
        log("scaleout", t0, f"{part.__name__}: {time.time() - t:.2f} s "
            + ("ok" if good else "FAILED"))
        ok = ok and good
    return ok


# the bench phase's arguments: python -m minivideo_tpu_torch.bench's
# defaults (1080p, batch 16, 16 batches a run, 3 runs)
BENCH_ARGS = ["--iters", "16", "--runs", "3"]


def bench_x264(t0):
    """The committed libx264 stream on the card against libavcodec."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.testing import streams as st
    with open(st.X264_STREAM, "rb") as f:
        data = f.read()
    recon_fused.wave_kernel_cuda.launches = 0
    pics = decode_annexb(data)
    launches = recon_fused.wave_kernel_cuda.launches
    got = [[sha(a) for a in p.cropped()] for p in pics]
    ok = (hashlib.sha256(data).hexdigest() == st.X264_SHA256
          and got == st.X264_LAVC_DIGESTS and launches == 1)
    log("bench", t0, f"libx264 stream ({len(data)} B, 4 slices, CABAC, "
        f"8x8) on the card: {len(pics)} pictures "
        f"{'=' if got == st.X264_LAVC_DIGESTS else '!='} libavcodec's "
        f"digests, wave_kernel launches {launches} (want 1) "
        + ("ok" if ok else "FAILED"))
    return ok


def phase_bench(t0, dev, streams):
    """The real-encoder stream and the port's bench on the card (see the
    docstring's phase 16).  Returns whether every check held."""
    import shutil
    import tempfile
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.ops import recon_fused
    ok = bench_x264(t0)
    t = time.time()
    prof = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with env(MINIVIDEO_TPU_PROFILE=prof):
            recon_fused.wave_kernel_cuda.launches = 0
            res = bench.run(BENCH_ARGS)
            launches = recon_fused.wave_kernel_cuda.launches
    except Exception as e:                    # noqa: BLE001 - reported
        log("bench", t0, f"bench {BENCH_ARGS} FAILED: {e!r}")
        return False
    finally:
        shutil.rmtree(prof, ignore_errors=True)
    secs = time.time() - t
    it, tr = res["iters"], res["trace"]
    dtr, ptr = tr["device_stage"], tr["pipeline"]
    checks = {
        "output check": res["output_check"] == "bit-exact",
        "4 checked pipeline runs": res["checked_runs"] == 4,
        "device-stage trace: 1 launch a batch":
            dtr["wave_kernel_launches"] == it,
        "pipeline trace: 1 launch a batch":
            ptr["wave_kernel_launches"] == it,
        # 4 staging copies in and 3 plane copies out per batch
        "pipeline trace: the copies' calls": ptr["memcpy_calls"] >= 7 * it,
        "launches = the bench's": launches == res["wave_kernel_launches"]
        > 0,
        "transfer included": res["transfer_included"] is True}
    x8 = res["high_profile_8x8"]
    log("bench", t0, f"bench {BENCH_ARGS} ({res['stream']} streams, "
        f"{res['staging']} staging, {res['host_cores']} host cores, "
        f"threads {res['threads']}) in {secs:.2f}s: overlapped pictures/s "
        f"(median, best of {res['runs']}; both copies included) CAVLC "
        f"{res['value_cavlc']:.2f}, {res['value_cavlc_best']:.2f}; CABAC "
        f"{res['value_cabac']:.2f}, {res['value_cabac_best']:.2f}; 8x8 "
        f"CAVLC {x8['e2e_median']['cavlc']:.2f}, "
        f"{x8['e2e_best']['cavlc']:.2f}; 8x8 CABAC "
        f"{x8['e2e_median']['cabac']:.2f}, {x8['e2e_best']['cabac']:.2f}; "
        f"device_fps {res['device_fps']:.1f} (records "
        f"{res['device_fps_records_staging']:.1f}; 8x8 "
        f"{x8['device_fps']:.1f}, {x8['device_fps_records_staging']:.1f}); "
        f"entropy fps CAVLC {res['entropy_cavlc_fps']:.1f} CABAC "
        f"{res['entropy_cabac_fps']:.1f}; thumbnails/s "
        f"{res['thumbnails_per_s']}; 4-slice latency "
        f"{res['slice_parallel']}; ring {res['ring']}")
    for name, t_ in (("device stage", dtr), ("pipeline run", ptr)):
        log("bench", t0, f"trace of the {name}: wave_kernel launches "
            f"{t_['wave_kernel_launches']} (batches {it}), wave_kernel run "
            f"on the card {t_['wave_kernel']}, cudaMemcpy calls "
            f"{t_['memcpy_calls']}, other kernels "
            f"{t_['other_kernels']}, H2D {t_['h2d']}, D2H {t_['d2h']}, "
            f"busy {t_['busy_ms']:.3f} of {t_['window_ms']:.3f} ms "
            f"({100 * t_['busy_share']:.2f}%)")
    log("bench", t0, "result " + json.dumps(res))
    log("bench", t0, "; ".join(f"{k}: {'ok' if v else 'FAILED'}"
                               for k, v in checks.items()))
    return ok and all(checks.values())


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
    from minivideo_tpu_torch.settings import staging_mode
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
                ("demux.cc (g++)", native.build_demux),
                ("export.cc (g++ -march=native, zlib)", native.build_export),
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
    # the plain loop takes seconds at 1080p: this run, after the smaller
    # ones above have warmed it up, is also its timing
    err1080, first, plain_ms = compare_kernel(packed, arrs)
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
    # host-clock breakdown of one decode_annexb batch, step by step, in
    # the staging layout that decode_annexb picks
    split = breakdown(stream, dev)
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
    log("timing", t0, f"decode_annexb steps ({staging_mode()} staging, "
        f"host clock, s, median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log("timing", t0, f"per 1080p batch of {BATCH}: wave_kernel "
        f"{kernel_ms:.3f} ms (B=1: {kernel1_ms:.3f} ms, "
        f"{kernel1_ms / (2 * hmb + wmb - 2) * 1e3:.2f} us per dependent "
        f"MB step), plain {plain_ms:.3f} ms (one run, phase 4), bound {bound_ms:.4f} ms "
        f"({nbytes} bytes); interleave {il_ms:.4f} ms, plain "
        f"{il_plain_ms:.4f} ms, permute().contiguous() {il_lib_ms:.4f} ms, "
        f"bound {il_bound_ms:.4f} ms ({il_bytes} bytes); decode_annexb "
        f"{BATCH / e2e_med:.2f} pictures/s (median of 3, {e2e_med:.3f}s)")

    # ---- 8.-17. CABAC, containers, files, staging layouts, Python
    # parsers, bad slices, thumbnails, the wave/lane/np engines,
    # scale-out, the bench
    # the 1080p batches of 16, and the two pictures alone
    streams = {"cavlc": stream, "cavlc2": data}
    for name, phase in (("cabac", phase_cabac),
                        ("containers", phase_containers),
                        ("files", phase_files),
                        ("staging", phase_staging),
                        ("parsers", phase_parsers),
                        ("bad slices", phase_bad_slices),
                        ("thumbnails", phase_thumbnails),
                        ("engines", phase_engines),
                        ("scaleout", phase_scaleout),
                        ("bench", phase_bench)):
        if not phase(t0, dev, streams):
            failed.append(name)

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
    log("total", t0, "command time")
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

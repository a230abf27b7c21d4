"""Where csrc/wave_kernel.cu spends its time, phase by phase, on the card.

    python -m minivideo_tpu_torch.ops.wave_phases

Builds the CUDA library as it ships plus -DMVT_PHASES (ops/kernels.py),
and runs it on the 1080p batch of 16 (testing.streams.STREAM_1080P) and
on its first picture alone.  For each it prints the median CUDA-event
milliseconds of 5 runs, checks that the planes equal those of
`wave_kernel_cuda` and that no wait timed out, and prints the
mean clock64 cycles per decoded MB of each phase: the consumer warp's
wait for its stage (fullwait), for the row above (rowwait), the
neighbour loads (nbload), luma and chroma prediction, the row stores and
the publish; the producer warps' wait for a free stage, the meta load and
the residual, and luma cycles by MB kind.  The marks cost time
themselves: chip_smoke.py times the kernel without them.  Needs a CUDA
card and nvcc; the card's name and power limit head the output.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import kernels
from . import recon_fused as rf

# (name, first mark, last mark) of csrc/wave_kernel.cu's PHASE marks
PHASES = (("fullwait", 0, 1), ("rowwait", 1, 2), ("nbload", 2, 3),
          ("luma", 3, 4), ("chroma", 4, 5), ("stores", 5, 6),
          ("publish", 6, 7), ("total", 0, 7), ("p_empty", 11, 12),
          ("p_meta", 12, 13), ("p_residual", 13, 14))
KINDS = ("I4x4", "I16x16", "I_PCM", "I8x8")      # meta row R_KIND values


DEFINES = ("-DMVT_PHASES",)


def load():
    """The library built with -DMVT_PHASES, bound with ctypes."""
    lib = kernels.load(DEFINES)
    lib.mvt_set_phases.restype = ctypes.c_int
    lib.mvt_set_phases.argtypes = [ctypes.c_void_p]
    return lib


def run(lib, packed, arrs, phases=None):
    """One launch of `lib`'s kernel on staging `arrs`; returns the planes
    and the error word.  `phases` (int64 [B, hmb, wmb, 16] on the card)
    receives the marks."""
    if lib.mvt_set_phases(0 if phases is None else phases.data_ptr()):
        raise RuntimeError("mvt_set_phases failed")
    *planes, word = rf._wave_launch(
        lambda: lib, *arrs, packed.ls4, packed.ls8, packed.wmb, packed.hmb,
        packed.has8x8, packed.haspcm)
    return planes, word


def report(lib, packed, arrs, want):
    """Event ms and mean phase cycles of one build on `arrs`."""
    times, words = [], [run(lib, packed, arrs)[1]]
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        got, word = run(lib, packed, arrs)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        words.append(word)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    B = arrs[0].shape[0]
    ph = torch.zeros((B, packed.hmb, packed.wmb, 16), dtype=torch.int64,
                     device=arrs[0].device)
    words.append(run(lib, packed, arrs, ph)[1])
    rf.check_waits(*words)
    p = ph.cpu().numpy()
    decoded = p[..., 3] > 0
    cycles = {name: float(np.mean((p[..., j] - p[..., i])[decoded]))
              for name, i, j in PHASES}
    luma = {KINDS[k]: float(np.mean((p[..., 4] - p[..., 3])[
        decoded & (p[..., 10] == k)]))
        for k in range(4) if (decoded & (p[..., 10] == k)).any()}
    return statistics.median(times), times, same, cycles, luma


def main():
    from ..models.h264.decoder import stage_annexb
    from ..testing.h264enc import make_stream
    from ..testing.streams import STREAM_1080P, repeat_pictures
    if not torch.cuda.is_available():
        print("wave_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    data = repeat_pictures(make_stream(**STREAM_1080P), 8)
    (_, packed), = stage_annexb(data, "cuda", staging_mode="device")
    arrs = rf.device_feeds(packed.arrays, packed.wmb, packed.hmb)
    kw = dict(has8x8=packed.has8x8, haspcm=packed.haspcm)
    batches = {16: arrs, 1: [a[:1] for a in arrs]}
    wants = {B: rf.wave_kernel_cuda(*a, packed.ls4, packed.ls8, packed.wmb,
                                    packed.hmb, **kw)
             for B, a in batches.items()}
    from .._build import LOGS
    lib = load()
    ptx = [ln.strip() for ln in LOGS.get(kernels.NAME, "").splitlines()
           if "registers" in ln or "spill" in ln]
    print(f"build {' '.join(DEFINES)}: {ptx}", flush=True)
    for B, a in batches.items():
        ms, times, same, cycles, luma = report(lib, packed, a, wants[B])
        print(f"  B={B}: {ms:.4f} ms (runs {[round(t, 4) for t in times]})"
              f", planes {'=' if same else '!='} wave_kernel_cuda | "
              f"card: {card}", flush=True)
        print("    cycles per decoded MB: " + ", ".join(
            f"{k} {v:.0f}" for k, v in cycles.items()), flush=True)
        print("    luma cycles by kind: " + ", ".join(
            f"{k} {v:.0f}" for k, v in luma.items()), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

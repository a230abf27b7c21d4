"""The yardstick of the kernel metrics: the bytes that reconstructing a
batch of intra pictures needs, whatever implements it, and the peak
bandwidth of each card the benchmark knows.

Per 16x16 macroblock the reconstruction reads, once, its residual
coefficients (384 of them: 256 luma and 2 x 64 chroma, as 16-bit values,
768 B), its prediction modes (16 luma modes at 4x4 granularity and the
chroma mode, 17 B) and its kind and QP (2 B), and writes its samples
once, at 1.5 bytes a luma sample of the coded size (384 B): 1,171 B.  The
count depends on the geometry and the batch alone, not on a staging
layout or on what a kernel reads again.
"""

from __future__ import annotations

RESIDUAL_B = 384 * 2
MODES_B = 16 + 1
KIND_QP_B = 2
PLANES_B = 256 + 128
MB_BYTES = RESIDUAL_B + MODES_B + KIND_QP_B + PLANES_B

# HBM bandwidth by torch.cuda.get_device_name(), bytes/s (NVIDIA's data
# sheet, SXM part, at its 700 W limit)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def wave_bytes(width: int, height: int, batch: int) -> int:
    """Bytes a batch of `batch` pictures of width x height (coded, in
    samples) needs read and written once."""
    return (width // 16) * (height // 16) * MB_BYTES * batch


def share(readings) -> float | None:
    """The wave kernel's share of its roofline in %: the least time the
    card could take for the bytes of one launch, over the mean device time
    of the launches the trace holds."""
    t = readings.trace
    peak = PEAK_BYTES_PER_S.get(readings.kind)
    if not t or not t["wave"][0] or not peak or not readings.per_launch:
        return None
    least = wave_bytes(*readings.size, readings.per_launch) / peak
    return 100.0 * least / (t["wave"][1] / t["wave"][0])


def h2d_ms_per_picture(readings) -> float | None:
    """Device milliseconds of host-to-device copies per decoded picture,
    scaled up by the share of the host's copy calls whose device record
    the profiler dropped."""
    t = readings.trace
    if not t or not t["h2d"][0] or not readings.pictures:
        return None
    seen = t["h2d"][0] + t["d2h"][0] + t["d2d"][0]
    cover = max(1.0, t["copy_calls"] / seen) if seen else 1.0
    return 1e3 * t["h2d"][1] * cover / readings.pictures


def idle_pct(readings) -> float | None:
    t = readings.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

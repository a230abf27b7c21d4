"""The arithmetic that turns a Chrome trace of torch.profiler into the
benchmark's device numbers.

`summarize` follows the arithmetic of minivideo_tpu_torch/bench.py's
`read_trace` (the card's busy time as the union of its kernels, copies and
memsets; copies by direction from the record's name), clipped to the
harness's window span, and adds what the per-layer metrics read: busy
time per card, device time by operation, the wave kernel's and the
copies' device time, how many of the host's copy calls have a device
record (the profiler can drop device records), and the idle gaps of the
cards by the host span that was open in each.  `pins.json` holds this
file's SHA-256, so a later change to it shows.
"""

from __future__ import annotations

import json

WINDOW_SPAN = "tvbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(spans, lo, hi):
    """Seconds covered by (start, end) microsecond spans, clipped to
    [lo, hi], and the uncovered gaps [(start, end), ...]."""
    busy, end, gaps = 0.0, lo, []
    for a, b in sorted(spans):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy / 1e6, gaps


def summarize(events, n_devices: int, host=None) -> dict:
    """What the metrics read from a torch.profiler Chrome trace (its
    "traceEvents"), inside the first "tvbench.window" user annotation.
    `host` = (host-clock second at which the window span opened, [(start,
    end, name), ...] host-clock spans of any thread) adds spans that the
    profiler did not record, placed by their offset from the window's
    start.  Returns {"window_s", "busy_s" (the mean over the n_devices
    cards used), "busy_s_by_device", "device_ops" {name: seconds},
    "wave" (count, seconds), "h2d" / "d2h" / "d2d" (count, seconds,
    bytes), "copy_calls" (host cudaMemcpy* calls), "idle_by_span" {the
    innermost host span open in each idle gap of the cards: seconds}}."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError(f"no {WINDOW_SPAN} span in the trace")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    by_dev, ops, spans, all_dev = {}, {}, [], []
    if host is not None:
        w0, intervals = host
        spans = [(lo + (a - w0) * 1e6, lo + (b - w0) * 1e6, n)
                 for a, b, n in intervals]
    wave = [0, 0.0]
    copies = {"h2d": [0, 0.0, 0], "d2h": [0, 0.0, 0], "d2d": [0, 0.0, 0]}
    copy_calls = 0
    for e in xs:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur <= lo or ts >= hi:
            continue
        cat, name = e.get("cat"), str(e.get("name", ""))
        if cat == "user_annotation" and name != WINDOW_SPAN:
            spans.append((ts, ts + dur, name))
        elif cat == "cuda_runtime" and name.startswith("cudaMemcpy"):
            copy_calls += 1
        if cat not in _DEVICE_CATS:
            continue
        dev = e.get("args", {}).get("device", e.get("pid"))
        by_dev.setdefault(dev, []).append((ts, ts + dur))
        all_dev.append((ts, ts + dur))
        ops[name] = ops.get(name, 0.0) + dur / 1e6
        if cat == "kernel" and "wave_kernel" in name:
            wave[0] += 1
            wave[1] += dur / 1e6
        elif cat == "gpu_memcpy":
            c = copies["h2d" if "HtoD" in name else "d2h" if "DtoH" in name
                          else "d2d"]
            c[0] += 1
            c[1] += dur / 1e6
            c[2] += int(e.get("args", {}).get("bytes", 0))
    busy = {str(d): _union(s, lo, hi)[0] for d, s in by_dev.items()}
    _, gaps = _union(all_dev, lo, hi)
    idle = {}
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        name = min(open_)[1] if open_ else "(no span)"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(busy.values()) / n_devices,
            "busy_s_by_device": busy, "device_ops": ops,
            "wave": tuple(wave),
            **{k: tuple(v) for k, v in copies.items()},
            "copy_calls": copy_calls, "idle_by_span": idle}


def load_events(path) -> list:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc

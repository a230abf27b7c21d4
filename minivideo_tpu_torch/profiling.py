"""Structured performance observability.

Port of minivideo_tpu/profiling.py.  Two tools:

- device_trace(logdir): context manager around a torch.profiler trace,
  CPU activity plus CUDA activity where a card is present, written as a
  Chrome trace (view with Perfetto or chrome://tracing) into `logdir`.
  Enabled from the outside via MINIVIDEO_TPU_PROFILE=<dir> — the batch
  pipeline wraps its reconstruction in it.  Degrades to a no-op where
  the profiler cannot start.  torch is imported only when a trace is
  taken.
- StageTimer: named wall-clock stage accumulator with a one-line
  summary, for the host-side pipeline stages (parse/entropy/recon/export).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from . import trace


@contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler trace if enabled and supported, else no-op.

    logdir defaults to $MINIVIDEO_TPU_PROFILE; no-op when unset.  Each
    trace is written to <logdir>/trace.<pid>.<ns>.json."""
    logdir = logdir or os.environ.get("MINIVIDEO_TPU_PROFILE")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    started = False
    try:
        prof.start()
        started = True
    except Exception as e:                  # noqa: BLE001 — degrade
        trace.warning("MAIN", "torch.profiler unavailable: %s", e)
    try:
        yield
    finally:
        if started:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                os.makedirs(logdir, exist_ok=True)
                path = os.path.join(
                    logdir, f"trace.{os.getpid()}.{time.time_ns()}.json")
                prof.export_chrome_trace(path)
                trace.info("MAIN", "device trace written to %s", path)
            except Exception as e:          # noqa: BLE001
                trace.warning("MAIN", "stopping the trace failed: %s", e)


class StageTimer:
    """Accumulates wall time + item counts per named pipeline stage."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.items: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.items[name] = self.items.get(name, 0) + items

    def summary(self) -> str:
        parts = []
        for name, s in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            n = self.items.get(name, 0)
            rate = f" ({n / s:.1f}/s)" if n and s > 0 else ""
            parts.append(f"{name}: {s:.3f}s{rate}")
        return " | ".join(parts)

    def report(self, module: str = "MAIN"):
        trace.info(module, "stage times: %s", self.summary())

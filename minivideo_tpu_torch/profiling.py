"""Structured performance observability: the port's one span recorder.

Port of minivideo_tpu/profiling.py, grown into a span recorder.

- span(name, items=0, nbytes=0): a context manager around one piece
  of work at a layer boundary.  Each record keeps the name, start and
  end on one host clock (time.perf_counter_ns), the thread, the span's
  id, its parent's id (the enclosing span on the same thread, or the
  span a pool task was submitted under, see carry), its item and byte
  counts, and the thread's CPU time inside it (time.thread_time_ns: the
  span's own work, without the time its thread waited for a core or
  the interpreter lock).  note(items, **info) inside the span sets a
  count known only once the work is done, and counters of the work
  (the record's `info`).  begin() opens a span that is not on the
  thread's stack, for work handed to a pool: it ends at the end of the
  last span under it.
- Tracing is on while a torch.profiler session is open in the process
  (torch.autograd.profiler._is_profiler_enabled, a process-wide flag):
  off, a span is one flag check and allocates nothing; on, records are
  kept in memory, and last_session() gives those of the last session
  that ended, the spans that began and ended inside it.  While on, a
  span made by span() on the thread that started the profiler is also a
  torch.profiler.record_function of its name, which lands in the Chrome
  trace on the trace's clock (the profiler keeps no other thread's
  annotations, so other threads make none).  The twin lies inside the
  span's start and end: its calls let go of the interpreter lock, and
  the wait to take it back falls inside the span, not between spans.
- device_trace(logdir): a torch.profiler trace, CPU activity plus CUDA
  activity where a card is present, written as a Chrome trace (view with
  Perfetto or chrome://tracing) into `logdir`, with the spans of every
  other thread (the parse pool, the pipeline's host thread, the export
  pool) on rows of their own, placed on the trace's clock by the offset
  measured between each of the profiler thread's spans and its
  record_function twin.  Enabled from the outside via
  MINIVIDEO_TPU_PROFILE=<dir>.  Degrades to a no-op where the profiler
  cannot start.  torch is imported only when a trace is taken.
- StageTimer: named stage accumulator with a one-line summary, for the
  host-side pipeline stages; each stage is also a span.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import sys
import threading
import time
from collections import namedtuple
from contextlib import contextmanager

from . import trace

_modules = sys.modules
_clock = time.perf_counter_ns
_cpu = time.thread_time_ns
_local = threading.local()        # .top: the innermost span; .thread
_ids = itertools.count(1)
_lock = threading.Lock()
_open = 0                         # serial of the session being recorded
_serial = 0
_records: list = []               # records of the open session
_last: list = []                  # records of the last session that ended


class Record(namedtuple("Record", "name start_ns end_ns thread thread_name "
                                  "id parent items nbytes cpu_ns info",
                        defaults=(None,))):
    """One span that began and ended inside a profiler session: `thread`
    is the OS thread id (a Chrome trace's "tid"), `parent` 0 for none,
    `cpu_ns` the thread's CPU time inside the span (0 for a begin() span,
    whose work runs on other threads), `info` the counters of note() (a
    dict) or None."""

    __slots__ = ()

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def cpu_ms(self) -> float:
        return self.cpu_ns / 1e6


def _profiling() -> bool:
    p = _modules.get("torch.autograd.profiler")
    return p is not None and p._is_profiler_enabled


def _session(on: bool):
    """Open a session where the flag is first seen on; close the open one
    (its records become the last session's) where it is first seen off."""
    global _open, _serial, _records, _last
    with _lock:
        if on and not _open:
            _serial += 1
            _open, _records = _serial, []
        elif not on and _open:
            _open, _last, _records = 0, _records, []


def _thread():
    t = getattr(_local, "thread", None)
    if t is None:
        t = _local.thread = (threading.get_native_id(),
                             threading.current_thread().name)
    return t


class _Off:
    """What span() and begin() give while tracing is off."""

    __slots__ = ()
    id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def end(self):
        pass

    def note(self, items=None, **info):
        pass


_OFF = _Off()


class Span:
    """A span while tracing is on (made by span() or begin())."""

    __slots__ = ("name", "items", "nbytes", "up", "id", "t0", "c0", "last",
                 "session", "prev", "twin", "stacked", "info")

    def __init__(self, name, items, nbytes, stacked):
        self.name, self.items, self.nbytes = name, items, nbytes
        self.stacked, self.last, self.twin = stacked, 0, None
        self.info = None
        if not _open:
            _session(True)
        self.session = _open
        top = getattr(_local, "top", None)
        self.up = top if top is not None and top.id else None
        self.id = next(_ids)
        self.c0 = _cpu() if stacked else 0
        self.t0 = _clock()
        if stacked:
            from torch._C._autograd import _profiler_enabled
            self.prev, _local.top = top, self
            if _profiler_enabled():       # the profiler's own thread
                from torch.autograd.profiler import record_function
                self.twin = record_function(name)
                self.twin.__enter__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def note(self, items=None, **info):
        """Set the item count (where given) and the counters of the
        record's `info`."""
        if items is not None:
            self.items = items
        self.info = dict(self.info or {}, **info)

    def end(self):
        if self.twin is not None:
            self.twin.__exit__(None, None, None)
        t1 = _clock()
        cpu = _cpu() - self.c0 if self.stacked else 0
        if self.stacked:
            _local.top = self.prev
        elif self.last:
            t1 = self.last            # a pool batch ends with its last task
        up = self.up
        if up is not None and not up.stacked:
            with _lock:
                up.last = max(up.last, t1)
        records = _records
        if _profiling() and _open == self.session:
            tid, tname = _thread()
            records.append(Record(self.name, self.t0, t1, tid, tname,
                                  self.id, up.id if up is not None else 0,
                                  self.items, self.nbytes, cpu, self.info))
        elif not _profiling():
            _session(False)


def span(name: str, items: int = 0, nbytes: int = 0):
    """A span of `name` over a `with` block, counting `items` (pictures,
    slices, files) and `nbytes`."""
    p = _modules.get("torch.autograd.profiler")
    if p is None or not p._is_profiler_enabled:
        if _open:
            _session(False)
        return _OFF
    return Span(name, items, nbytes, True)


def begin(name: str, items: int = 0):
    """A span of `name` begun now and not on this thread's stack: the
    parent of the pool tasks submitted under it (carry).  It ends at the
    end of the last span under it, or at end() where none ran."""
    if not _profiling():
        if _open:
            _session(False)
        return _OFF
    return Span(name, items, 0, False)


def carry(fn, parent=None):
    """`fn`, to run on a pool thread under `parent` (default: this
    thread's innermost span), so the spans it opens are that span's
    children.  Off, `fn` itself."""
    if not _profiling():
        return fn
    up = parent if parent is not None else getattr(_local, "top", None)
    if up is None or not up.id:
        return fn

    def run(*args, **kw):
        prev = getattr(_local, "top", None)
        _local.top = up
        try:
            return fn(*args, **kw)
        finally:
            _local.top = prev

    return run


def last_session() -> list:
    """The records of the last torch.profiler session that has ended:
    every span that began and ended inside it, each thread's.  A session
    ends where a span, begin() or this function first finds the profiler
    off, so two sessions with none of these between them read as one."""
    if _open and not _profiling():
        _session(False)
    return list(_last)


def _merge_spans(path: str, records, tid: int) -> dict:
    """Write into the Chrome trace at `path` the spans of `records` made
    on threads other than `tid` (the thread that ran the profiler, whose
    spans the trace holds as their record_function twins), one row per
    thread, on the trace's clock: the offset is the median over the
    twins, paired by name and order, of the twin's start less the span's.
    Returns {"offset_us", "twins", "residual_us" [median, largest] of
    |twin - span - offset|, "written"}; nothing is written where the
    trace holds no twin."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ann = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    twins, mine = {}, {}
    for e in sorted(ann, key=lambda e: float(e["ts"])):
        if e.get("tid") == tid:
            twins.setdefault(e["name"], []).append(float(e["ts"]))
    for r in sorted(records, key=lambda r: r.start_ns):
        if r.thread == tid:
            mine.setdefault(r.name, []).append(r.start_ns / 1e3)
    diffs = [a - b for name, starts in mine.items()
             if len(twins.get(name, ())) == len(starts)
             for a, b in zip(twins[name], starts)]
    if not diffs:
        return {"offset_us": None, "twins": 0, "residual_us": None,
                "written": 0}
    offset = statistics.median(diffs)
    res = [abs(d - offset) for d in diffs]
    seen = {e.get("tid") for e in ann}
    pid = next((e.get("pid") for e in ann if e.get("tid") == tid),
               os.getpid())
    names, added = {}, []
    for r in records:
        if r.thread in seen:
            continue
        names[r.thread] = r.thread_name
        added.append({"ph": "X", "cat": "host_span", "name": r.name,
                      "pid": pid, "tid": r.thread,
                      "ts": r.start_ns / 1e3 + offset,
                      "dur": (r.end_ns - r.start_ns) / 1e3,
                      "args": {"span": r.id, "parent": r.parent,
                               "items": r.items, "bytes": r.nbytes,
                               "cpu_us": r.cpu_ns / 1e3, **(r.info or {})}})
    added += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
               "args": {"name": n}} for t, n in names.items()]
    events.extend(added)
    summary = {"offset_us": offset, "twins": len(diffs),
               "residual_us": [statistics.median(res), max(res)],
               "written": len(added) - len(names)}
    if isinstance(doc, dict):
        doc["hostSpans"] = summary
    with open(path, "w") as f:
        json.dump(doc, f)
    return summary


@contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler trace if enabled and supported, else no-op.

    logdir defaults to $MINIVIDEO_TPU_PROFILE; no-op when unset.  Each
    trace is written to <logdir>/trace.<pid>.<ns>.json, with the spans
    of every thread (_merge_spans)."""
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
                spans = _merge_spans(path, last_session(),
                                     threading.get_native_id())
                trace.info("MAIN", "device trace written to %s (%s)", path,
                           spans)
            except Exception as e:          # noqa: BLE001
                trace.warning("MAIN", "stopping the trace failed: %s", e)


class StageTimer:
    """Accumulates wall time + item counts per named pipeline stage, each
    stage also a span (of `span_name`, default the stage's name)."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.items: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str, items: int = 0, span_name: str | None = None):
        t0 = _clock()
        try:
            with span(span_name or name, items):
                yield
        finally:
            dt = (_clock() - t0) / 1e9
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

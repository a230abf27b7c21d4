"""The port's span recorder (minivideo_tpu_torch/profiling.py) on the
CPU: nothing is recorded without a torch.profiler session; under one, the
pipeline (bench.Bench.overlapped), batch_thumbnail and decode_annexb give
their named spans, one a slice, batch, file, picture or output, each
under its parent, pool tasks under the span that submitted them;
device_trace writes the other threads' spans into its Chrome trace,
placed on the trace's clock; the PARALLEL trace mask prints
batch_thumbnail's stage line.  (The port is imported inside the tests
and fixtures: see torch_port_helpers.py.)"""

import io
import json
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_batch import clips  # noqa: F401 - the shared fixture

WMB, HMB, BATCH, ITERS, SLICES = 5, 4, 2, 3, 2


def _session(fn):
    """(fn(), the recorder's records) under a CPU torch.profiler session."""
    from torch.profiler import ProfilerActivity, profile
    from minivideo_tpu_torch import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.last_session()


def _named(records, name):
    return [r for r in records if r.name == name]


def _bench_run(bench_mod):
    import torch
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    data = make_stream2(width_mbs=WMB, height_mbs=HMB, n_pictures=3,
                        seed=5, entropy="cabac", n_slices=SLICES)
    b = bench_mod.Bench(torch.device("cpu"), WMB, HMB, BATCH, ITERS, 1)
    try:
        b.overlapped(bench_mod.prep_pictures(data), lambda i, planes: None)
    finally:
        b.close()


def test_no_session_records_nothing():
    """Off, span() and begin() hand back one shared object, allocate
    nothing, and leave the last session as it was."""
    from minivideo_tpu_torch import profiling
    _, before = _session(lambda: None)
    with profiling.span("x.outside", 3) as s:
        pass
    b = profiling.begin("x.detached")
    b.end()
    assert s is b and s.id == 0
    assert profiling.carry(len) is len
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        for _ in range(1000):
            with profiling.span("x.off", 1):
                pass
        grown = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert grown < 512, grown
    assert profiling.last_session() == before


def test_a_session_keeps_what_began_and_ended_in_it():
    """The last session's spans, each with its thread and parent; a span
    still open when the session closes is dropped; a later session
    replaces the records."""
    from torch.profiler import ProfilerActivity, profile
    from minivideo_tpu_torch import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("x.outer", 2) as outer:
            with profiling.span("x.inner", nbytes=7):
                pass
        late = profiling.span("x.late")
        late.__enter__()
    late.__exit__(None, None, None)
    recs = profiling.last_session()
    assert [r.name for r in recs] == ["x.inner", "x.outer"]
    inner, o = recs
    assert (inner.parent, o.parent, o.id) == (outer.id, 0, outer.id)
    assert (o.items, inner.nbytes) == (2, 7)
    assert o.start_ns <= inner.start_ns <= inner.end_ns <= o.end_ns
    assert inner.thread == threading.get_native_id() and inner.ms >= 0
    _, again = _session(lambda: profiling.span("x.again").__enter__()
                        .__exit__(None, None, None))
    assert [r.name for r in again] == ["x.again"]


def test_cpu_time_leaves_out_waiting():
    """A span's cpu_ns is its thread's CPU time: a span that waits on a
    lock reads its wall time but little CPU, one that computes reads
    both; a begin() span, whose work runs elsewhere, reads 0."""
    from minivideo_tpu_torch import profiling
    held = threading.Lock()

    def run():
        with profiling.span("x.wait"):
            held.acquire(timeout=0.05)
        with profiling.span("x.work"):
            t = time.perf_counter() + 0.05
            while time.perf_counter() < t:
                pass
        profiling.begin("x.detached").end()

    held.acquire()
    try:
        _, recs = _session(run)
    finally:
        held.release()
    wait, = _named(recs, "x.wait")
    work, = _named(recs, "x.work")
    detached, = _named(recs, "x.detached")
    assert wait.ms >= 45 and wait.cpu_ms < wait.ms / 2
    assert 0 < work.cpu_ms <= work.ms * 1.05 and work.ms >= 45
    assert detached.cpu_ns == 0


def test_twins_only_on_the_profiler_s_thread(monkeypatch):
    """Only the thread that started the profiler makes record_function
    twins (the profiler keeps no other thread's); every thread's spans
    are recorded."""
    import torch.autograd.profiler as tprof
    from minivideo_tpu_torch import profiling
    made = []
    real = tprof.record_function

    class Counting(real):
        def __init__(self, name, *a, **kw):
            made.append((name, threading.get_native_id()))
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(tprof, "record_function", Counting)

    def run():
        with profiling.span("x.main"):
            with ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(profiling.carry(
                    lambda: profiling.span("x.pool").__enter__()
                    .__exit__(None, None, None))).result()

    _, recs = _session(run)
    assert made == [("x.main", threading.get_native_id())]
    main, = _named(recs, "x.main")
    pool, = _named(recs, "x.pool")
    assert pool.parent == main.id and pool.thread != main.thread


def test_pool_tasks_are_children_of_their_submitter():
    """carry() runs a task under the submitting span on a pool thread;
    a begin() span ends with its last child."""
    from minivideo_tpu_torch import profiling

    def task(i):
        with profiling.span("x.task", 1):
            return threading.get_native_id()

    def run():
        with ThreadPoolExecutor(max_workers=3) as pool:
            with profiling.span("x.submit") as s:
                tids = list(pool.map(profiling.carry(task), range(6)))
            b = profiling.begin("x.batch", 4)
            futs = [pool.submit(profiling.carry(task, b), i)
                    for i in range(4)]
            for f in futs:
                f.result()
            b.end()
        return s, b, tids

    (s, b, tids), recs = _session(run)
    tasks = _named(recs, "x.task")
    assert len(tasks) == 10
    assert sum(r.parent == s.id for r in tasks) == 6
    mine = [r for r in tasks if r.parent == b.id]
    batch, = _named(recs, "x.batch")
    assert len(mine) == 4 and batch.items == 4
    assert batch.end_ns == max(r.end_ns for r in mine)
    assert {r.thread for r in tasks} == set(tids) | {r.thread for r in mine}
    assert threading.get_native_id() not in {r.thread for r in tasks}


@pytest.mark.parametrize("mode", ["device", "records"])
def test_pipeline_spans(monkeypatch, tmp_path, mode):
    """bench.Bench.overlapped on the CPU: a bench.parse_slice a slice
    under its batch's bench.parse_batch, one pack, wait_host, enqueue,
    wait_card and consume a batch, the ring's acquire a batch, and its
    clear: in the records mode one a reused set under its acquire, in
    the device mode one a batch under its pack (zero_uncovered)."""
    from minivideo_tpu_torch import bench
    monkeypatch.setattr(bench, "CACHE", str(tmp_path))
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", mode)
    _, recs = _session(lambda: _bench_run(bench))
    batches = _named(recs, "bench.parse_batch")
    slices = _named(recs, "bench.parse_slice")
    assert len(batches) == ITERS and all(b.items == BATCH for b in batches)
    assert len(slices) == ITERS * BATCH * SLICES
    assert sum(r.items for r in slices) == ITERS * BATCH
    assert all(r.nbytes > 0 for r in slices)
    for b in batches:
        mine = [r for r in slices if r.parent == b.id]
        assert len(mine) == BATCH * SLICES
        assert b.start_ns <= min(r.start_ns for r in mine)
        assert b.end_ns == max(r.end_ns for r in mine)
    host = {b.thread for b in batches}
    assert {b.thread_name for b in batches} == {"bench-host"}
    assert host.isdisjoint(r.thread for r in slices)
    for name in ("bench.pack", "bench.wait_host", "bench.enqueue",
                 "bench.wait_card", "bench.consume"):
        assert len(_named(recs, name)) == ITERS, name
    main = threading.get_native_id()
    assert {r.thread for r in _named(recs, "bench.wait_card")} == {main}
    acquire = _named(recs, "bench.ring_acquire")
    clear = _named(recs, "bench.ring_clear")
    assert len(acquire) == ITERS
    if mode == "device":
        assert len(clear) == ITERS
        assert {r.parent for r in clear} <= {
            r.id for r in _named(recs, "bench.pack")}
    else:
        assert len(clear) == ITERS - 2
        assert {r.parent for r in clear} <= {r.id for r in acquire}


def test_batch_thumbnail_spans(clips, tmp_path):  # noqa: F811
    """batch_thumbnail(device="cpu") under a caller's span: a
    batch.demux_file a file under batch.demux, a batch.parse_picture a
    picture under batch.entropy, an export.picture an output under the
    caller's span, and the calling thread's stage, launch, readback,
    export and manifest spans."""
    from minivideo_tpu_torch import profiling
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch_thumbnail

    def call():
        with profiling.span("x.call"):
            return batch_thumbnail(
                clips, str(tmp_path), device="cpu", pictures_per_clip=2,
                fmt=PictureFormat.YUV420)

    res, recs = _session(call)
    caller, = _named(recs, "x.call")
    demux, = _named(recs, "batch.demux")
    files = _named(recs, "batch.demux_file")
    assert len(files) == len(clips) and demux.items == len(clips)
    assert {r.parent for r in files} == {demux.id}
    entropy = _named(recs, "batch.entropy")
    assert len(entropy) == 2
    pictures = _named(recs, "batch.parse_picture")
    assert len(pictures) == sum(e.items for e in entropy) == res.frames + 2
    for e in entropy:
        assert sum(r.parent == e.id for r in pictures) == e.items
    outs = _named(recs, "export.picture")
    assert len(outs) == len(res.outputs) == 8
    assert {r.parent for r in outs} == {caller.id}
    main = threading.get_native_id()
    assert main not in {r.thread for r in files + pictures + outs}
    for name in ("batch.recon", "batch.stage", "batch.launch",
                 "batch.readback"):
        assert len(_named(recs, name)) == 2, name
        assert {r.thread for r in _named(recs, name)} == {main}
    recon = {r.id for r in _named(recs, "batch.recon")}
    assert {r.parent for r in _named(recs, "batch.launch")} <= recon
    assert len(_named(recs, "batch.export")) == 1
    assert len(_named(recs, "batch.manifest")) == 1 + res.done


def test_file_api_spans(tmp_path):
    """mv_decode's path: decode.nalu, decode.parse and decode.stage, once
    a decode_annexb call of one (SPS, PPS) part; stage_annexb's too."""
    from minivideo_tpu_torch.models.h264.decoder import (decode_annexb,
                                                        stage_annexb)
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(width_mbs=4, height_mbs=3, n_pictures=2, seed=9)
    for fn in (lambda: decode_annexb(data, device="cpu"),
               lambda: stage_annexb(data, "cpu")):
        _, recs = _session(fn)
        names = [r.name for r in recs if r.name.startswith("decode.")]
        assert sorted(names) == ["decode.nalu", "decode.parse",
                                 "decode.stage"]
        assert _named(recs, "decode.nalu")[0].nbytes == len(data)
        assert _named(recs, "decode.parse")[0].items == 2


def test_device_trace_writes_every_thread_s_spans(monkeypatch, tmp_path):
    """device_trace's Chrome trace holds the pool's and the host thread's
    spans on rows of their own, and an offset measured on the twins;
    each of the profiler thread's spans made while no other thread
    contends for the interpreter, placed by that offset, lies within
    1 ms of its record_function twin.  (Under contention a thread can
    lose the interpreter between the span's stamp and the twin's, for up
    to sys.getswitchinterval(): PERF.md gives those residuals on the
    H100.)"""
    from minivideo_tpu_torch import bench, profiling
    monkeypatch.setattr(bench, "CACHE", str(tmp_path))
    with profiling.device_trace(str(tmp_path / "prof")):
        _bench_run(bench)
        for i in range(8):
            with profiling.span("x.quiet", i):
                time.sleep(0.001)
    path, = (tmp_path / "prof").iterdir()
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    spans = doc["hostSpans"]
    assert spans["twins"] == 4 * ITERS + 8
    added = [e for e in events if e.get("cat") == "host_span"]
    main = threading.get_native_id()
    assert main not in {e["tid"] for e in added}
    slices = [e for e in added if e["name"] == "bench.parse_slice"]
    assert len(slices) == ITERS * BATCH * SLICES
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "bench-host" in {rows[e["tid"]] for e in added}
    assert {e["tid"] for e in slices} <= set(rows)
    twins = sorted(e["ts"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("tid") == main and e["name"] == "x.quiet")
    recs = sorted(r.start_ns / 1e3 + spans["offset_us"]
                  for r in profiling.last_session() if r.name == "x.quiet")
    assert len(twins) == len(recs) == 8
    for a, b in zip(twins, recs):
        assert abs(a - b) <= 1000, a - b


def test_stage_timer_stages_are_spans():
    """StageTimer: its seconds and items as before, each stage a span of
    its span name."""
    from minivideo_tpu_torch.profiling import StageTimer
    t = StageTimer()

    def run():
        with t.stage("parse", 3, "batch.demux"):
            pass
        with t.stage("export", 1):
            pass
    _, recs = _session(run)
    assert [(r.name, r.items) for r in recs] == [("batch.demux", 3),
                                                 ("export", 1)]
    assert t.items == {"parse": 3, "export": 1} and set(t.acc) == {
        "parse", "export"}


@pytest.mark.parametrize("mask", ["PARALLEL:info", ""])
def test_parallel_mask_prints_the_stage_line(clips, tmp_path,  # noqa: F811
                                             monkeypatch, mask):
    """MINIVIDEO_TPU_TRACE=PARALLEL:info prints batch_thumbnail's stage
    line; without it nothing is printed."""
    from minivideo_tpu_torch import trace
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch_thumbnail
    monkeypatch.setenv("MINIVIDEO_TPU_TRACE", mask)
    out = io.StringIO()
    old = dict(trace._state.masks), trace._state.stream
    try:
        trace._state.stream = out
        trace._init_from_env()
        batch_thumbnail([c for c in clips if c.endswith("c0.264")],
                        str(tmp_path), device="cpu",
                        fmt=PictureFormat.YUV420)
    finally:
        trace._state.masks.clear()
        trace._state.masks.update(old[0])
        trace._state.stream = old[1]
    lines = [ln for ln in out.getvalue().splitlines() if "stage times" in ln]
    if mask:
        assert len(lines) == 1 and lines[0].startswith("[INFO ] [PARALLEL]")
        assert "parse: " in lines[0] and "export: " in lines[0]
    else:
        assert lines == []

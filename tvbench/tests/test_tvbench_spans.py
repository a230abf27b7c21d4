"""The per-layer metrics read from the program's span recorder
(minivideo_tpu_torch.profiling.last_session): each reader on a stub
session, None where there is nothing to read or no recorder, and a
number from every one in a traced run of each driver at the tiny size."""

import pytest

from .conftest import CELLS, run_tiny

SPANS = {  # metric -> the cell's kind
    "entropy_ms_per_picture.decode": "pipeline",
    "parse_ms_per_batch.decode": "pipeline",
    "demux_ms_per_file.thumb": "batch",
    "entropy_ms_per_picture.thumb": "batch",
    "export_ms_per_thumbnail.thumb": "batch",
}


def _rec(name, ms, items=1, cpu_ms=0.0):
    from minivideo_tpu_torch.profiling import Record
    return Record(name, 1000, 1000 + int(ms * 1e6), 1, "t", 1, 0, items, 0,
                  int(cpu_ms * 1e6))


def test_readers_on_a_stub_session(monkeypatch):
    from minivideo_tpu_torch import profiling
    from tvbench import run
    session = [
        _rec("bench.parse_slice", 30, 1), _rec("bench.parse_slice", 10, 0),
        _rec("bench.parse_slice", 20, 1),
        _rec("bench.parse_batch", 90), _rec("bench.parse_batch", 100),
        _rec("batch.demux_file", 19, cpu_ms=2),   # waited for the lock
        _rec("batch.demux_file", 6, cpu_ms=4),
        _rec("batch.parse_picture", 50), _rec("export.picture", 12),
        _rec("batch.manifest", 1000)]
    monkeypatch.setattr(profiling, "last_session", lambda: session)
    want = {"entropy_ms_per_picture.decode": 30.0,   # 60 ms, 2 pictures
            "parse_ms_per_batch.decode": 95.0,
            "demux_ms_per_file.thumb": 3.0,     # thread CPU, not wall
            "entropy_ms_per_picture.thumb": 50.0,
            "export_ms_per_thumbnail.thumb": 12.0}
    for name, value in want.items():
        assert run.reader(name)(None) == pytest.approx(value), name
    monkeypatch.setattr(profiling, "last_session", lambda: [])
    for name in SPANS:
        assert run.reader(name)(None) is None, name


def test_readers_without_the_recorder(monkeypatch):
    """A program without the recorder (the parent commit's) reads None."""
    from minivideo_tpu_torch import profiling
    from tvbench import run
    monkeypatch.delattr(profiling, "last_session")
    for name in SPANS:
        assert run.reader(name)(None) is None, name


def test_every_span_metric_is_in_the_spec():
    from tvbench import inputs, run
    spec = inputs.benchmark()
    for name, kind in SPANS.items():
        m, = [m for m in spec["per_layer"] if m["name"] == name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == [CELLS[kind][0]]
        _, per = run.cell_metrics(spec, CELLS[kind][0])
        assert name in {p["name"] for p in per}


@pytest.mark.parametrize("kind", ["pipeline", "batch"])
def test_a_traced_run_reads_every_span_metric(kind, tmp_path, one_thread):
    out, notes = run_tiny(kind, tmp_path, trace=1, seconds=2)
    assert out["correct"], (out, notes)
    for name, k in SPANS.items():
        if k == kind:
            assert out["metrics"][name]["value"] > 0, name

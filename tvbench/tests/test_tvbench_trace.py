"""The trace arithmetic on a small committed Chrome trace."""

import os

import pytest

from tvbench import tracearith as T
from tvbench.metrics import _roofline as R

PATH = os.path.join(os.path.dirname(__file__), "data", "trace_small.json")


def test_summarize_window_cards_and_gaps():
    s = T.summarize(T.load_events(PATH), 2)
    assert s["window_s"] == pytest.approx(2000e-6)
    assert s["busy_s_by_device"] == {"0": pytest.approx(450e-6),
                                     "1": pytest.approx(400e-6)}
    assert s["busy_s"] == pytest.approx(425e-6)
    assert s["wave"] == (2, pytest.approx(500e-6))
    assert s["h2d"] == (2, pytest.approx(200e-6), 2000)
    assert s["d2h"] == (1, pytest.approx(50e-6), 500)
    assert s["copy_calls"] == 4
    assert "outside" not in s["device_ops"]
    assert s["idle_by_span"] == {
        "parallel.batch_thumbnail": pytest.approx(1390e-6)}


def test_host_spans_attribute_the_gaps():
    host = (10.0, [(10.0 + 600e-6, 10.0 + 1950e-6, "api.mv_decode")])
    s = T.summarize(T.load_events(PATH), 2, host=host)
    # the gap from 1,650 to 2,900 us lies inside the shorter host span
    assert s["idle_by_span"]["api.mv_decode"] == pytest.approx(1250e-6)


def test_metrics_from_the_summary():
    s = T.summarize(T.load_events(PATH), 2)

    class Rd:
        trace, pictures, per_launch = s, 4, 16
        size, kind = (128, 96), "NVIDIA H100 80GB HBM3"
    assert R.idle_pct(Rd) == pytest.approx(100 * (1 - 425 / 2000))
    # 4 copy calls, 3 device records: scaled by 4/3
    assert R.h2d_ms_per_picture(Rd) == pytest.approx(
        1e3 * 200e-6 * 4 / 3 / 4)
    assert R.share(Rd) == pytest.approx(
        100 * (8 * 6 * 1171 * 16 / 3.35e12) / 250e-6)


def test_no_window_span_raises():
    with pytest.raises(ValueError):
        T.summarize([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                      "dur": 1}], 1)


def test_ring_clear_reader():
    from tvbench import run

    class Rd:
        spans = {"ring_clear": [0.04, 0.02]}
    assert run.reader("ring_clear_ms_per_batch.decode")(Rd) == \
        pytest.approx(30)
    Rd.spans = {}
    assert run.reader("ring_clear_ms_per_batch.decode")(Rd) is None

"""The harness on the card at the tiny size, traced and not: run on the
chip with `python3 -m pytest tvbench/tests -m cuda`; each test skips
without enough cards."""

import pytest

from .conftest import CELLS, MIXES, run_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind", sorted(MIXES))
def test_tiny_cell_on_the_card(kind, trace, tmp_path):
    import torch
    need = CELLS[kind][1]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} CUDA card(s)")
    out, notes = run_tiny(kind, tmp_path, trace=trace, device="cuda")
    assert out["correct"], (out, notes)
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == need
    assert out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]

"""The BDAV writer of the m2ts mix (containers/m2ts.py): whole aligned
units of 192-byte source packets with rising arrival time stamps, whose
video payloads a plain reader gathers back into the Annex-B input; and a
traced run of the batch driver over .m2ts files at the tiny size that
reads the cell's two metrics of the program's spans."""

import time

import numpy as np
import pytest

from tvbench import inputs
from tvbench.containers import m2ts, split_annexb

from .conftest import tiny_config


def _plain(data, pid=0x1011):
    """(arrival time stamps, the payloads of the PES units of `pid` with
    their PES headers stripped): a source-packet reader of its own."""
    ats, units = [], []
    for i in range(0, len(data), 192):
        ats.append(int.from_bytes(data[i:i + 4], "big") & 0x3FFFFFFF)
        p = data[i + 4:i + 192]
        assert p[0] == 0x47
        if ((p[1] & 0x1F) << 8 | p[2]) != pid or not p[3] & 0x10:
            continue
        q = 4 + (1 + p[4] if p[3] & 0x20 else 0)
        if p[1] & 0x40:
            units.append(bytearray())
        units[-1] += p[q:]
    out = []
    for u in units:
        assert u[:4] == b"\x00\x00\x01\xe0"
        out.append(bytes(u[9 + u[8]:]))
    return ats, out


def _tiny_stream(order):
    return inputs.reorder(inputs.stream(tiny_config(), "tiny"), order)


@pytest.mark.parametrize("order", [[0, 1], [1, 0]])
def test_aligned_units_rising_stamps_and_the_input_back(order):
    annexb = _tiny_stream(order)
    data = m2ts.write(annexb, 128, 96)
    assert len(data) % (32 * 192) == 0
    ats, units = _plain(data)
    assert all(b > a for a, b in zip(ats, ats[1:]))
    assert b"".join(units) == annexb
    assert len(units) == len(order)
    # each unit is one picture: its slices, first_mb_in_slice 0 first
    for u in units:
        slices = [n for _, n in split_annexb(u) if n[0] & 0x1F == 5]
        assert len(slices) == 4 and slices[0][1] & 0x80


def test_a_traced_run_over_m2ts_files(tmp_path, one_thread):
    import torch
    from tvbench import run
    mix = {"driver": "batch", "container": "m2ts", "stream": "tiny",
           "files": 4, "sampled_per_call": 2, "file_checks": 2}
    out, notes = run.run_cell(
        "thumb-m2ts-s4-jpg-b64", inputs.benchmark(), tiny_config(), mix,
        2**31 + 12345, 2, 1, [torch.device("cpu")], str(tmp_path),
        time.perf_counter())
    assert out["correct"], (out, notes)
    assert set(out["metrics"]) == {"ts_demux_ms_per_file.thumb",
                                   "entropy_ms_per_slice.thumb"}
    assert all(np.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())

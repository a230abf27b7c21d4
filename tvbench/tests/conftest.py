"""Shared pieces of the benchmark's CPU tests: the tiny configuration (a
128x96 libx264 stream of 2 pictures, 4 slices each, CABAC with the 8x8
transform) and small traffic mixes of each driver."""

import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_config():
    from tvbench import inputs
    return inputs.load_json(os.path.join(HERE, "tiny.json"))


MIXES = {
    "pipeline": {"driver": "pipeline", "stream": "tiny", "batch": 4,
                 "warmup_batches": [2, 4], "sampled_batches": 2},
    "batch": {"driver": "batch", "container": "mp4", "stream": "tiny",
              "files": 6, "sampled_per_call": 2, "file_checks": 3},
}
# the cell whose metrics each mix reports, and its device count
CELLS = {"pipeline": ("decode-cabac8x8-pipe-b16", 1),
         "batch": ("thumb-mp4-jpg-b64", 1)}


def run_tiny(kind, tmp_path, seed=987654321098, trace=0, seconds=1,
             device="cpu"):
    """One run of the harness at the tiny size, on the CPU unless
    `device` names a card ("cuda": as many cards as the cell asks for):
    (result, notes)."""
    import time
    import torch
    from tvbench import inputs, run
    config = tiny_config()
    if kind == "pipeline":
        config.pop("thumbnailer")
    wname, n = CELLS[kind]
    devices = ([torch.device(f"cuda:{i}") for i in range(n)]
               if device == "cuda" else [torch.device(device)] * n)
    return run.run_cell(wname, inputs.benchmark(), config, MIXES[kind], seed,
                        seconds, trace, devices, str(tmp_path),
                        time.perf_counter())


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""Where the harness finds a cell's parts by name, and the one generator of
its inputs.

A cell is an entry of `workloads` in BENCHMARK.json.  Its configuration
is `configs/<config>.json` (the deployment: the committed stream of each
kind and the thumbnailer's flags), its traffic mix `traffic/<traffic>.json`
(the parameters of the driver it names, `drivers/<driver>.py`, and of
the container writer, `containers/<container>.py`), and each per-layer
metric `metrics/<metric>.py` (a reader, `read(readings)`).  A later cell,
mix, driver, container or metric is a new file and a new entry; no file
here changes.

Inputs come from the seed alone: each input is the configuration's
committed stream (pinned by SHA-256) with its pictures put in an order
drawn from the seed, so every seed decodes the same pictures, in another
order, and the reference knows which picture each answer is.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .containers import split_annexb, writer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def part(kind: str, name: str) -> dict:
    """configs/<name>.json or traffic/<name>.json."""
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"tvbench: no {kind} file {path}")
    return load_json(path)


def cell(name: str, spec: dict | None = None):
    """(workload entry, configuration, traffic) of the cell `name`."""
    spec = spec or benchmark()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w, part("configs", w["config"]), part("traffic",
                                                         w["traffic"])
    raise SystemExit(f"tvbench: no workload {name!r} in BENCHMARK.json")


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator of the seed (any non-negative integer) and `keys`."""
    return np.random.default_rng([int(seed), *map(int, keys)])


def stream(config: dict, key: str) -> bytes:
    """The committed stream `key` of the configuration, held to its
    SHA-256 (raises where the file is missing or altered)."""
    s = config["streams"][key]
    path = os.path.join(HERE, s["file"])
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != s["sha256"]:
        raise RuntimeError(f"{path}: SHA-256 is not the pinned one")
    return data


def pictures_of(data: bytes):
    """The NALUs of an Annex-B stream grouped by picture: each group holds
    the parameter sets and SEI before the picture and its IDR slices (a
    picture starts at a slice with first_mb_in_slice 0); what trails the
    last slice stays with the last picture."""
    groups, pending = [], []
    for _, nal in split_annexb(data):
        t = nal[0] & 0x1F
        if t == 5 and (nal[1] & 0x80 or not groups):
            groups.append(pending + [nal])
            pending = []
        elif t == 5:
            groups[-1].append(nal)
        else:
            pending.append(nal)
    if not groups:
        raise ValueError("no IDR picture in the stream")
    groups[-1].extend(pending)
    return groups


def reorder(data: bytes, order) -> bytes:
    """The stream with its pictures in `order` (indices of the original)."""
    groups = pictures_of(data)
    return b"".join(b"\x00\x00\x00\x01" + u
                    for i in order for u in groups[int(i)])


def write_files(config: dict, traffic: dict, seed: int, outdir: str):
    """The mix's input files under `outdir`: traffic["files"] files of the
    container traffic["container"], file f holding the stream's pictures
    in the order rng(seed, f) draws.  Returns [(path, first picture)]."""
    data = stream(config, traffic["stream"])
    n_pics = config["streams"][traffic["stream"]]["pictures"]
    size = config["streams"][traffic["stream"]]["coded_size"]
    write = writer(traffic["container"])
    os.makedirs(outdir, exist_ok=True)
    out = []
    for f in range(traffic["files"]):
        order = rng(seed, f).permutation(n_pics)
        path = os.path.join(outdir, f"clip_{f:04d}.{traffic['container']}")
        with open(path, "wb") as fh:
            fh.write(write(reorder(data, order), *size))
        out.append((path, int(order[0])))
    return out

"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

import json
import os
import re

from tvbench import check, drivers, inputs, run
from tvbench.containers import writer

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = inputs.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["tvbench"] and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    raw = open(os.path.join(inputs.ROOT, "BENCHMARK.json")).read()
    assert len(raw.encode()) <= 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["file"].startswith("tvbench/")
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_every_cell_finds_its_parts_and_reports_enough():
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        _, config, traffic = inputs.cell(w["name"], SPEC)
        assert traffic["stream"] in config["streams"]
        assert issubclass(drivers.load(traffic["driver"]), drivers.Driver)
        if "container" in traffic:
            assert callable(writer(traffic["container"]))
        if "thumbnailer" in config:
            fmt = check.file_format(config["thumbnailer"]["format"])
            assert callable(fmt.check_file) and callable(fmt.encode)
        e2e, per = run.cell_metrics(SPEC, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per
        for m in per:
            assert m["moves"] in names
            assert callable(run.reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        for name in m.get("workloads", []):
            assert name in {w["name"] for w in SPEC["workloads"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_configs_pin_their_streams():
    for c in SPEC["configs"]:
        config = inputs.part("configs", c["name"])
        assert os.path.join("tvbench", "configs", c["name"] + ".json") == \
            c["file"]
        for key, s in config["streams"].items():
            data = inputs.stream(config, key)
            assert len(inputs.pictures_of(data)) == s["pictures"]
            assert len(s["libavcodec_sha256"]) == s["pictures"]
        # every cut from the source is a key of the file, listed in reduced
        assert c["source"] == config["source"]
        assert all(k in config for k in c["reduced"])
        assert set(c["reduced"]) <= set(config) - {
            "source", "what", "thumbnailer", "guarantees", "streams"}


def test_frozen_copies_match_their_pins():
    import hashlib
    pins = inputs.load_json(os.path.join(inputs.HERE, "pins.json"))
    for rel, sha in pins.items():
        with open(os.path.join(inputs.HERE, rel), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == sha, rel


def test_layers_name_modules_of_the_port():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = open(os.path.join(inputs.ROOT, "PERF.md")).read()
    for layer in layers:
        assert layer in perf, layer
    json.dumps(SPEC)

"""The control, sent through the harness's own comparison, on the cards at
a cell's own sizes: the readings that the limits of check.py were set
from.  The benchmark's own runs never run this.

    python3 -m tvbench.control --workload <name> --seeds 1,2,3 --seconds 10

For each seed: one window of the program at the cell's load, and
check.compare of its answers (the sound reading); then the control put in
the program's place, and check.compare again.  The control is the plain
reference decoder with its inverse transforms in float32
(reference/decode.py): every sampled answer's planes become the control's
planes of its picture, and every sampled thumbnail file is rewritten as
reference/<format>.py's exact encoder makes it from them.  One JSON line
a seed on stdout: {"seed", "sound": {number: value}, "sound_correct",
"control": {number: value}, "control_correct", "parts", "seconds"}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

from . import check, inputs


def control_job(config, stream_key, index):
    """In a worker: the control's uncropped planes of picture `index`."""
    from .reference import decode as ref
    planes, _ = ref.decode_picture(inputs.stream(config, stream_key), index,
                                   control=True)
    return planes


def control_planes(config, stream_key, pictures) -> dict:
    """{picture: the control's uncropped planes}, a spawned process a
    picture."""
    pictures = sorted(set(pictures))
    if not pictures:
        return {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(len(pictures),
                                             os.cpu_count() or 1),
                             mp_context=ctx) as ex:
        return dict(zip(pictures, ex.map(
            control_job, [config] * len(pictures),
            [stream_key] * len(pictures), pictures)))


def put_in_place(driver, planes, file_checks):
    """Every answer of the driver shows `planes` of its picture, and each
    thumbnail file that the comparison samples is the exact encoder's of
    them, as if the control had made them in the window."""
    from .reference.decode import cropped
    stream = driver.config["streams"][driver.stream_key]
    th = driver.config.get("thumbnailer")
    written = {}
    pick = check.file_sample(driver.answers, driver.seed, file_checks)
    for i, a in enumerate(driver.answers):
        shown = cropped(planes[a.picture], stream["display_size"])
        a.planes = shown if a.cropped else planes[a.picture]
        if th and i in pick:
            if a.picture not in written:
                written[a.picture] = check.file_format(
                    th["format"]).encode(shown, th["quality"])
            with open(a.file, "wb") as f:
                f.write(written[a.picture])


def reading(driver, failed, file_checks):
    numbers, parts = check.compare(driver, failed, file_checks)
    return ({k: v["value"] for k, v in numbers.items()},
            all(v["value"] <= v["limit"] for v in numbers.values()), parts)


def run_seed(config, traffic, seed, seconds, devices, tmp, planes):
    """(sound reading, its `correct`, control reading, its `correct`,
    parts) of one seed; `planes` caches the control's pictures."""
    from . import drivers
    n = traffic.get("file_checks", 8)
    d = drivers.load(traffic["driver"])(config, traffic, seed, devices, tmp)
    d.setup(seconds)
    res = d.window()
    d.close()
    sound, sound_ok, _ = reading(d, res["failed"], n)
    need = {a.picture for a in d.answers} - set(planes)
    planes.update(control_planes(config, traffic["stream"], need))
    put_in_place(d, planes, n)
    ctrl, ctrl_ok, parts = reading(d, res["failed"], n)
    return sound, sound_ok, ctrl, ctrl_ok, parts


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m tvbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=10)
    a = ap.parse_args(argv)
    import torch
    w, config, traffic = inputs.cell(a.workload)
    if torch.cuda.device_count() < w["chips"]:
        print(f"tvbench.control: {a.workload} needs {w['chips']} cards",
              file=sys.stderr)
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(w["chips"])]
    planes = {}
    for seed in (int(s) for s in a.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="tvbench.") as tmp:
            t0 = time.perf_counter()
            sound, sound_ok, ctrl, ctrl_ok, parts = run_seed(
                config, traffic, seed, a.seconds, devices, tmp, planes)
            print(json.dumps({
                "seed": seed, "sound": sound, "sound_correct": sound_ok,
                "control": ctrl, "control_correct": ctrl_ok,
                "parts": parts, "seconds": time.perf_counter() - t0}),
                flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell of the benchmark of minivideo_tpu_torch (the
PyTorch and CUDA port) on the cards of this machine.

    python3 -m tvbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell's configuration, traffic mix and per-layer metrics are found by
name from BENCHMARK.json (inputs.py).  The run makes its inputs from the
seed, warms up (set-up, timed from the first line of this file to the
start of the window), runs the window, reads the peak device memory,
checks that no module of JAX or of the JAX package was loaded, frees the
program's state, holds a sample of the window's answers to libavcodec's
digests of their pictures (check.py), and prints one JSON line on stdout:
with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from a torch.profiler trace of the window
(tracearith.py) and from the harness's spans.  The numbers compared and
their limits come last on stderr and last in the JSON line ("checks").

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, where the program is missing, and where a module
of jax, jaxlib, flax or minivideo_tpu was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import check, inputs  # noqa: E402

CACHE = os.path.join(inputs.ROOT, ".tvbench_cache")
FILE_CHECKS = 8          # thumbnail files held to the reference a run


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class ForbiddenImport(RuntimeError):
    pass


class Readings:
    """What a per-layer metric reads: `trace` (tracearith.summarize of
    the window, or None), `spans` {name: [seconds, ...]} of the harness
    and the program, `pictures` decoded in the window, `per_launch`
    pictures a wave-kernel launch holds, the coded `size`, the card's
    `kind`."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def reader(name):
    """The `read` of metrics/<name>.py."""
    path = os.path.join(inputs.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "tvbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec, wname):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if wname in m.get("workloads", [wname])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (wname in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def breakdown(t):
    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(t["device_ops"]),
            "idle_gaps": top(t["idle_by_span"])}


def run_cell(wname, spec, config, traffic, seed, seconds, trace, devices,
             tmpdir, t0):
    """One run; returns (result object, notes).  `devices` are the torch
    devices the cell runs on (cards on the chip, "cpu" in the tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import drivers
    from .tracearith import load_events, summarize

    cuda = [d for d in devices if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    e2e, per = cell_metrics(spec, wname)
    driver = drivers.load(traffic["driver"])(config, traffic, seed, devices,
                                             tmpdir)
    t_setup = time.perf_counter()
    with record_function("tvbench.setup"):
        driver.setup(seconds)
    sync()
    setup_s = time.perf_counter() - t0
    phases = {"before_setup": t_setup - t0}
    for a, b, name in driver.intervals:
        phases[name] = phases.get(name, 0.0) + b - a
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    with record_function("tvbench.window"):
        res = driver.window()
        sync()
    window_s = time.perf_counter() - w0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(tmpdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        summary = summarize(load_events(path), len(devices),
                            host=(w0, driver.intervals))
        os.remove(path)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda),
               default=0)
    bad = check.forbidden_modules()
    if bad:
        raise ForbiddenImport(f"loaded in the run's process: {bad}")
    kind = torch.cuda.get_device_name(cuda[0]) if cuda else "cpu"
    driver.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, parts = check.compare(
        driver, res["failed"], traffic.get("file_checks", FILE_CHECKS))
    notes = dict(driver.notes, setup_s=setup_s, setup_phases=phases,
                 cores=len(os.sched_getaffinity(0)),
                 cpu_count=os.cpu_count(), window_s=window_s,
                 checked=parts, check_s=time.perf_counter() - t_check,
                 spans={k: [len(v), sum(v)] for k, v in
                        driver.spans.items()})
    if trace:
        r = Readings(trace=summary, spans=driver.spans,
                     pictures=driver.pictures,
                     per_launch=driver.per_launch, size=driver.size,
                     kind=kind)
        metrics = {}
        for m in per:
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        notes["trace"] = {k: summary[k] for k in
                          ("wave", "h2d", "d2h", "d2d", "copy_calls",
                           "busy_s_by_device")}
    else:
        values = {"setup_s": setup_s, driver.e2e: res["count"] / window_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": len(devices), "memory_peak_bytes": peak}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=summary["busy_s"],
                      window_s=summary["window_s"])
        out["breakdown"] = breakdown(summary)
    out["checks"] = checks
    return out, notes


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m tvbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0 or a.seconds < 1:
        ap.error("--seed must be >= 0 and --seconds >= 1")
    return a


def main(argv=None):
    args = parse(argv)
    spec = inputs.benchmark()
    workload, config, traffic = inputs.cell(args.workload, spec)
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ.setdefault(k, os.path.join(CACHE, k.lower()))
    import minivideo_tpu_torch  # noqa: F401 - the program must be here
    import torch
    need = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"tvbench: {args.workload} needs {need} CUDA card(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count()}")
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(need)]
    tmpdir = tempfile.mkdtemp(prefix="tvbench.")
    try:
        out, notes = run_cell(args.workload, spec, config, traffic,
                              args.seed, args.seconds, args.trace, devices,
                              tmpdir, T0)
    except ForbiddenImport as e:
        log(f"tvbench: {e}")
        return 3
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    bad = check.forbidden_modules()
    if bad:
        log(f"tvbench: loaded in the run's process: {bad}")
        return 3
    log("tvbench: " + json.dumps(notes, default=str))
    for name, c in out["checks"].items():
        log(f"tvbench check: {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

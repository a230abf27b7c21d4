"""The drivers that traffic mixes name (`"driver"` in
traffic/<name>.json), one module each: drivers/<driver>.py holds
`DRIVER`, a subclass of `Driver`.  A driver takes a configuration, the
mix's parameters, the seed and the devices, makes its inputs in set-up,
warms up the shapes its traffic uses, runs the window, and hands the
answers it sampled to the check.  Drivers call the program under test,
minivideo_tpu_torch, only through its own entry points, each call inside
a torch.profiler.record_function named after it.  A later mix that needs
another driver is a new module here.
"""

from __future__ import annotations

import importlib
import re
import time


def load(name: str):
    """The DRIVER of drivers/<name>.py."""
    if not re.fullmatch(r"[a-z0-9_]+", name):
        raise ValueError(f"no driver {name!r}")
    return importlib.import_module(f"{__name__}.{name}").DRIVER


def _span(name):
    from torch.profiler import record_function
    return record_function(name)


class _Timed:
    """A record_function of `name` that also keeps (start, end, name) on
    the host clock in `intervals`: the set-up phases that a run reports,
    and the host spans by which tracearith.summarize attributes the idle
    gaps (torch.profiler keeps no annotation made on a thread other than
    the one that started it)."""

    def __init__(self, intervals, name):
        self.intervals, self.name = intervals, name

    def __enter__(self):
        self.rf = _span(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        self.intervals.append((self.t0, t1, self.name))


class Answer:
    """One sampled answer: the picture of the configuration's stream it
    should show, its planes as the program handed them on (uncropped for
    the decode, display-cropped for a thumbnail), and the path of the
    thumbnail file written, if any."""

    __slots__ = ("picture", "planes", "cropped", "file", "where")

    def __init__(self, picture, planes, cropped, file=None, where=""):
        self.picture, self.planes, self.cropped = picture, planes, cropped
        self.file, self.where = file, where


class Driver:
    """What every driver has: its cell, its readings and its answers."""

    e2e = ""                     # the end-to-end metric it reports

    def __init__(self, config, traffic, seed, devices, tmpdir):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.devices, self.tmp = devices, tmpdir
        self.stream_key = traffic["stream"]
        s = config["streams"][self.stream_key]
        self.size = tuple(s["coded_size"])
        self.n_pictures = s["pictures"]
        self.answers: list[Answer] = []
        self.spans: dict = {}        # name -> [seconds, ...]
        self.pictures = 0            # pictures decoded in the window
        self.per_launch = 0          # pictures a wave-kernel launch holds
        self.notes: dict = {}        # printed on stderr
        self.intervals: list = []    # (start, end, name), host clock

    def timed(self, name):
        return _Timed(self.intervals, name)

    def launches(self):
        from minivideo_tpu_torch.ops import recon_fused as rf
        return dict(rf.wave_kernel_cuda.launches_by_device)

    def close(self):
        pass

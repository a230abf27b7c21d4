"""Per-module leveled tracing.

TPU-native equivalent of the reference's MiniTraces subsystem
(reference: minivideo/src/minitraces.{c,h}, minitraces_conf.h): six severity
levels as a bitmask, per-module masks, colored terminal output with
file/function decoration, optional timestamps.  Unlike the reference (printf
macros compiled in/out by build type), this is runtime-configurable via
`set_module_mask` / the MINIVIDEO_TPU_TRACE environment variable.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

# Severity bits (reference: minitraces.h:58-67)
ERROR = 1 << 0
WARNING = 1 << 1
INFO = 1 << 2
LVL1 = 1 << 3
LVL2 = 1 << 4
LVL3 = 1 << 5

_LEVEL_NAMES = {
    ERROR: ("ERROR", "\x1b[1;31m"),
    WARNING: ("WARN ", "\x1b[1;33m"),
    INFO: ("INFO ", "\x1b[1;32m"),
    LVL1: ("LVL1 ", "\x1b[0;36m"),
    LVL2: ("LVL2 ", "\x1b[0;35m"),
    LVL3: ("LVL3 ", "\x1b[0;90m"),
}

_DEFAULT_MASK = ERROR | WARNING

# Module registry, mirroring the reference's 25-module table
# (minitraces_conf.h:83-151) adapted to this package's layout.
MODULES = (
    "MAIN", "BITS", "IO", "PROBE", "DEMUX", "MP4", "AVI", "RIFF", "WAVE",
    "MKV", "MP3", "PS", "PES", "TS", "ES", "FILTER", "H264", "NALU",
    "PARAM", "SLICE", "MB", "CAVLC", "CABAC", "INTRA", "TRANS", "SPATIAL",
    "EXPORT", "MUXER", "OPS", "MESH", "PARALLEL",
)


@dataclass
class _TraceState:
    masks: dict = field(default_factory=lambda: {m: _DEFAULT_MASK for m in MODULES})
    colors: bool = True
    timestamps: bool = False
    stream: object = None
    t0: float = field(default_factory=time.monotonic)


_state = _TraceState()


def _init_from_env() -> None:
    # MINIVIDEO_TPU_TRACE="H264:info,CABAC:lvl3,*:warn"
    spec = os.environ.get("MINIVIDEO_TPU_TRACE", "")
    names = {"error": ERROR, "warn": ERROR | WARNING, "info": ERROR | WARNING | INFO,
             "lvl1": 0x0F, "lvl2": 0x1F, "lvl3": 0x3F, "off": 0}
    for part in filter(None, spec.split(",")):
        mod, _, lvl = part.partition(":")
        mask = names.get(lvl.strip().lower(), _DEFAULT_MASK)
        if mod == "*":
            for m in _state.masks:
                _state.masks[m] = mask
        elif mod in _state.masks:
            _state.masks[mod] = mask


_init_from_env()


def set_module_mask(module: str, mask: int) -> None:
    _state.masks[module] = mask


def set_global_mask(mask: int) -> None:
    for m in _state.masks:
        _state.masks[m] = mask


def enable_timestamps(on: bool = True) -> None:
    _state.timestamps = on


def trace(level: int, module: str, fmt: str, *args) -> None:
    if not (_state.masks.get(module, _DEFAULT_MASK) & level):
        return
    name, color = _LEVEL_NAMES[level]
    out = _state.stream or sys.stderr
    msg = fmt % args if args else fmt
    ts = ""
    if _state.timestamps:
        ts = "[%8.3f] " % (time.monotonic() - _state.t0)
    if _state.colors and out.isatty():
        out.write(f"{ts}{color}[{name}]\x1b[0m [{module}] {msg}\n")
    else:
        out.write(f"{ts}[{name}] [{module}] {msg}\n")


def error(module: str, fmt: str, *args) -> None:
    trace(ERROR, module, fmt, *args)


def warning(module: str, fmt: str, *args) -> None:
    trace(WARNING, module, fmt, *args)


def info(module: str, fmt: str, *args) -> None:
    trace(INFO, module, fmt, *args)


def t1(module: str, fmt: str, *args) -> None:
    trace(LVL1, module, fmt, *args)


def t2(module: str, fmt: str, *args) -> None:
    trace(LVL2, module, fmt, *args)


def t3(module: str, fmt: str, *args) -> None:
    trace(LVL3, module, fmt, *args)

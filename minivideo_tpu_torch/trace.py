"""Leveled per-module tracing (the subset of minivideo_tpu/trace.py the
port's decode path uses).

MINIVIDEO_TPU_TRACE="H264:info,*:warn" sets per-module masks, as in the
JAX package.
"""

from __future__ import annotations

import os
import sys

ERROR = 1 << 0
WARNING = 1 << 1
INFO = 1 << 2
LVL1 = 1 << 3
LVL2 = 1 << 4
LVL3 = 1 << 5

_NAMES = {ERROR: "ERROR", WARNING: "WARN ", INFO: "INFO ", LVL1: "LVL1 ",
          LVL2: "LVL2 ", LVL3: "LVL3 "}
_DEFAULT_MASK = ERROR | WARNING
_masks: dict = {}


def _init_from_env() -> None:
    spec = os.environ.get("MINIVIDEO_TPU_TRACE", "")
    names = {"error": ERROR, "warn": ERROR | WARNING,
             "info": ERROR | WARNING | INFO, "lvl1": 0x0F, "lvl2": 0x1F,
             "lvl3": 0x3F, "off": 0}
    for part in filter(None, spec.split(",")):
        mod, _, lvl = part.partition(":")
        _masks[mod] = names.get(lvl.strip().lower(), _DEFAULT_MASK)


_init_from_env()


def trace(level: int, module: str, fmt: str, *args) -> None:
    mask = _masks.get(module, _masks.get("*", _DEFAULT_MASK))
    if not mask & level:
        return
    msg = fmt % args if args else fmt
    sys.stderr.write(f"[{_NAMES[level]}] [{module}] {msg}\n")


def warning(module: str, fmt: str, *args) -> None:
    trace(WARNING, module, fmt, *args)


def t1(module: str, fmt: str, *args) -> None:
    trace(LVL1, module, fmt, *args)


def t2(module: str, fmt: str, *args) -> None:
    trace(LVL2, module, fmt, *args)


def t3(module: str, fmt: str, *args) -> None:
    trace(LVL3, module, fmt, *args)

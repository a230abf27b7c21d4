"""The container writers that make the input files, one module a
container, found by the name a traffic mix gives (`"container"`):
containers/<name>.py holds `write(annexb, width, height) -> bytes`.  A
later mix in a new container is a new module here.

`split_annexb` is a frozen copy of minivideo_tpu_torch/models/h264/nalu.py's
as it stood when the benchmark was written (`pins.json`).
"""

from __future__ import annotations

import importlib
import re


def writer(name: str):
    """The `write` of containers/<name>.py."""
    if not re.fullmatch(r"[a-z0-9_]+", name):
        raise ValueError(f"no container {name!r}")
    return importlib.import_module(f"{__name__}.{name}").write


def split_annexb(data: bytes):
    """Split an Annex-B byte stream into (offset, nalu_bytes) units.

    Accepts both 3-byte and 4-byte start codes.  `nalu_bytes` includes the
    header byte but not the start code.
    """
    units = []
    n = len(data)
    i = data.find(b"\x00\x00\x01")
    while i != -1:
        start = i + 3
        j = data.find(b"\x00\x00\x01", start)
        end = j if j != -1 else n
        # trim trailing zero bytes that belong to the next start code
        while end > start and data[end - 1] == 0:
            end -= 1
        if end > start:
            units.append((start, data[start:end]))
        i = j
    return units

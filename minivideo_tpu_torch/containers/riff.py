"""RIFF container primitives shared by AVI and WAVE.

Reference: minivideo/src/demuxer/riff/riff.c — list/chunk header parsing
and resync (:46-259).
"""

from __future__ import annotations

import struct

from .. import trace


def read_chunk_header(fh):
    """Returns (fourcc: bytes, size: int, data_offset: int) or None."""
    hdr = fh.read(8)
    if len(hdr) < 8:
        return None
    fcc = hdr[:4]
    size = struct.unpack("<I", hdr[4:])[0]
    return fcc, size, fh.tell()


def iter_chunks(fh, end: int):
    """Iterate (fourcc, size, offset) of sibling chunks until `end`;
    yields LIST chunks with their list type as ('LIST', type, size, off).
    Sizes are clamped to the parent (reference jumpy_riff, riff.c:259)."""
    while fh.tell() + 8 <= end:
        pos = fh.tell()
        h = read_chunk_header(fh)
        if h is None:
            return
        fcc, size, off = h
        if off + size > end:
            trace.warning("RIFF", "chunk %s size %d overruns parent; "
                          "clamping", fcc, size)
            size = end - off
        if fcc in (b"LIST", b"RIFF"):
            list_type = fh.read(4)
            yield (fcc, list_type, size - 4, off + 4)
        else:
            yield (fcc, None, size, off)
        # chunks are word-aligned
        fh.seek(off + size + (size & 1))

"""Windowed file views for the streaming demuxers.

The reference never holds more than a 128 KiB window of the input in
memory (bitstream.c:51, ``buffer_feed_dynamic`` :259-338); the round-3
demuxers for TS/PS/MKV/ES/MP3 slurped whole files instead, which a
pod-scale job hitting multi-GB recordings cannot afford.  FileWindow
restores the bounded-memory property while presenting the tiny subset
of the ``bytes`` API those demuxers use — ``len()``, integer indexing,
contiguous slices and ``find`` — so the parser logic is unchanged and
identical for in-memory and windowed operation.

Access pattern contract: the demuxers advance mostly forward; a read
outside the current window simply re-centres it (one seek + one read),
so random access is correct, just not cached across distant hops.
"""

from __future__ import annotations

DEFAULT_WINDOW = 256 << 10          # 2x the reference's 128 KiB


class FileWindow:
    """Bounded sliding-window view of a binary file."""

    __slots__ = ("_fh", "_size", "_win", "_base", "_buf")

    def __init__(self, fh, size: int | None = None,
                 window: int | None = None):
        self._fh = fh
        if size is None:
            fh.seek(0, 2)
            size = fh.tell()
        self._size = int(size)
        # None -> module default, read at call time so tests can shrink
        # it to force window slides on small fixtures
        self._win = max(int(window or DEFAULT_WINDOW), 1 << 12)
        self._base = 0
        self._buf = b""

    def __len__(self) -> int:
        return self._size

    def _load(self, off: int) -> None:
        off = max(0, min(off, self._size))
        self._fh.seek(off)
        self._buf = self._fh.read(self._win)
        self._base = off

    def __getitem__(self, key):
        if isinstance(key, slice):
            a, b, step = key.indices(self._size)
            if step != 1:
                raise ValueError("FileWindow slices must be contiguous")
            if b <= a:
                return b""
            if b - a > self._win:
                # oversized slice: direct read, window untouched
                self._fh.seek(a)
                return self._fh.read(b - a)
            if a < self._base or b > self._base + len(self._buf):
                self._load(a)
            return self._buf[a - self._base:b - self._base]
        if key < 0:
            key += self._size
        if not 0 <= key < self._size:
            raise IndexError("FileWindow index out of range")
        if not self._base <= key < self._base + len(self._buf):
            self._load(key)
        return self._buf[key - self._base]

    def find(self, needle: bytes, start: int = 0,
             end: int | None = None) -> int:
        """bytes.find semantics over the file, scanning window-by-window
        with a len(needle)-1 overlap carried between windows."""
        n = len(needle)
        if n == 0:
            return max(0, min(start, self._size))
        stop = self._size if end is None else min(end, self._size)
        pos = max(0, start)
        while pos + n <= stop:
            if pos < self._base or pos + n > self._base + len(self._buf):
                self._load(pos)
            wend = min(self._base + len(self._buf), stop)
            idx = self._buf.find(needle, pos - self._base,
                                 wend - self._base)
            if idx != -1:
                return self._base + idx
            nxt = wend - (n - 1)
            if nxt <= pos:
                break
            pos = nxt
        return -1

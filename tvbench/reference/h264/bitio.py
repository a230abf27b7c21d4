"""Bit-level reader over in-memory buffers.

Host-side equivalent of the reference's bitstream layer
(reference: minivideo/src/bitstream.{c,h}, bitstream_utils.{c,h}).  Key
differences by design: samples are handed to the parser as whole `bytes`
buffers (the demuxer owns file I/O), so there is no 128 KiB sliding-window
refill logic, and premature EOF raises `BitstreamError` instead of the
reference's `exit(EXIT_FAILURE)` (bitstream.c:285, a known reference bug we
deliberately do not replicate — TODO.md:32).
"""

from __future__ import annotations


class BitstreamError(Exception):
    """Raised on reads past the end of the buffer or malformed data."""


class BitReader:
    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes, start_bit: int = 0):
        self.data = data
        self.nbits = len(data) * 8
        self.pos = start_bit

    # -- positioning --------------------------------------------------------

    def bit_position(self) -> int:
        return self.pos

    def byte_position(self) -> int:
        return self.pos >> 3

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def is_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        """Advance to the next byte boundary (bitstream_utils.c:152-187)."""
        self.pos = (self.pos + 7) & ~7

    def skip_bits(self, n: int) -> None:
        if self.pos + n > self.nbits:
            raise BitstreamError("skip past end of stream")
        self.pos += n

    def rewind_bits(self, n: int) -> None:
        if n > self.pos:
            raise BitstreamError("rewind past start of stream")
        self.pos -= n

    def goto_bit(self, bitpos: int) -> None:
        if not (0 <= bitpos <= self.nbits):
            raise BitstreamError("seek out of range")
        self.pos = bitpos

    # -- reads ---------------------------------------------------------------

    def read_bit(self) -> int:
        p = self.pos
        if p >= self.nbits:
            raise BitstreamError("read past end of stream")
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def read_bits(self, n: int) -> int:
        """Read up to 64 bits MSB-first (bitstream.c:431,552)."""
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.nbits:
            raise BitstreamError("read past end of stream")
        self.pos = p + n
        first = p >> 3
        last = (p + n - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        shift = ((last + 1) << 3) - (p + n)
        return (chunk >> shift) & ((1 << n) - 1)

    def peek_bit(self) -> int:
        p = self.pos
        if p >= self.nbits:
            raise BitstreamError("peek past end of stream")
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def peek_bits(self, n: int) -> int:
        save = self.pos
        try:
            return self.read_bits(n)
        finally:
            self.pos = save

    def read_bytes(self, n: int) -> bytes:
        """Byte-aligned raw read."""
        if self.pos & 7:
            raise BitstreamError("read_bytes on unaligned position")
        p = self.pos >> 3
        if (p + n) * 8 > self.nbits:
            raise BitstreamError("read past end of stream")
        self.pos += n * 8
        return self.data[p:p + n]

    # -- H.264 RBSP helpers (bitstream_utils.c:201-417) ----------------------

    def more_data(self) -> bool:
        return self.pos < self.nbits

    def h264_more_rbsp_data(self) -> bool:
        """True if there is more RBSP payload before the trailing bits.

        The RBSP ends with a final stop bit '1' followed by zero bits to the
        end; scan backwards for that stop bit (spec 7.2; reference
        bitstream_utils.c:276-387 does a forward start-code scan because it
        streams from disk — we hold the whole (unescaped) RBSP in memory so
        the backward scan is exact).
        """
        if self.pos >= self.nbits:
            return False
        # find last set bit in the buffer
        data = self.data
        i = len(data) - 1
        while i >= 0 and data[i] == 0:
            i -= 1
        if i < 0:
            return False
        byte = data[i]
        # index of lowest set bit
        low = (byte & -byte).bit_length() - 1
        stop_bit_pos = i * 8 + (7 - low)  # bit offset of the final '1'
        return self.pos < stop_bit_pos

    def h264_rbsp_trailing_bits(self) -> bool:
        """Consume rbsp_stop_one_bit + alignment zeros
        (bitstream_utils.c:239)."""
        if self.read_bit() != 1:
            return False
        while not self.is_aligned():
            if self.read_bit() != 0:
                return False
        return True

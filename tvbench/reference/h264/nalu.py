"""NAL unit handling: Annex-B splitting, header parse, RBSP unescaping.

Reference: minivideo/src/decoder/h264/h264_nalu.{c,h} — header parse
(h264_nalu.c:109-179) and emulation-prevention removal `nalu_clean_sample`
(h264_nalu.c:195-249).  Unescaping here is done host-side on whole sample
buffers so device kernels always see clean RBSP with static shapes
(see SURVEY.md §7 "hard parts" item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class NaluType(IntEnum):
    UNSPECIFIED = 0
    SLICE = 1           # coded slice, non-IDR
    SLICE_DPA = 2
    SLICE_DPB = 3
    SLICE_DPC = 4
    SLICE_IDR = 5       # coded slice, IDR picture
    SEI = 6
    SPS = 7
    PPS = 8
    AUD = 9             # access unit delimiter
    END_SEQUENCE = 10
    END_STREAM = 11
    FILLER = 12
    SPS_EXT = 13
    PREFIX = 14
    SUBSET_SPS = 15
    SLICE_AUX = 19
    SLICE_SVC = 20


@dataclass
class Nalu:
    nal_ref_idc: int
    nal_unit_type: NaluType
    rbsp: bytes          # emulation-prevention-free payload (no header byte)
    offset: int = 0      # byte offset of the NALU payload in its source


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation-prevention bytes: 00 00 03 -> 00 00 (spec 7.4.1.1).

    Reference: nalu_clean_sample (h264_nalu.c:195-249).  The scan goes
    from one 00 00 03 to the next with bytes.find, not byte by byte: a
    dense 1080p slice holds thousands of them.
    """
    i = data.find(b"\x00\x00\x03")
    if i == -1:
        return data
    parts, start = [], 0
    while i != -1:
        parts.append(data[start:i + 2])
        start = i + 3
        i = data.find(b"\x00\x00\x03", start)
    parts.append(data[start:])
    return b"".join(parts)


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (for the fixture encoder / muxer)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def parse_nalu(data: bytes, offset: int = 0) -> Nalu:
    """Parse a NALU (header byte + escaped payload) into header + clean RBSP.

    Reference: nalu_parse_header (h264_nalu.c:109-179).  SVC/MVC 3-byte
    extensions (types 14/20) are not consumed here; those NALU types are
    rejected upstream like the reference does (h264_slice.c:258-262).
    """
    if not data:
        raise ValueError("empty NALU")
    hdr = data[0]
    if hdr & 0x80:
        raise ValueError("forbidden_zero_bit set")
    return Nalu(
        nal_ref_idc=(hdr >> 5) & 3,
        nal_unit_type=NaluType(hdr & 0x1F),
        rbsp=unescape_rbsp(data[1:]),
        offset=offset,
    )


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

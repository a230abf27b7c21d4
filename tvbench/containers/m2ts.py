"""The BDAV writer of the benchmark's input files (Blu-ray .m2ts, AVCHD
.mts): a frozen copy of `write_m2ts` (with `access_units`) of
minivideo_tpu_torch/testing/containers.py as it stood when the cell was
written, at its defaults and without its null-packet interleave and
fixed mux rate, which no mix uses.  It is a copy so that a change to the
program's writers does not move the inputs.

Blu-ray Disc Read-Only Format, Part 3: 192-byte source packets, each a
4-byte TP_extra_header (copy_permission_indicator 0, a 30-bit arrival
time stamp at 27 MHz) before a 188-byte TS packet.  PAT and PMT (program
1 on PID 0x0100, an HDMV registration descriptor, PCR on the video PID)
go before every access unit, each unit one video PES on PID 0x1011
(stream_type 0x1B) with its PTS at 23.976 pictures/s, the PCR in the
adaptation field of its first packet; null packets pad the file to whole
aligned units of 32 source packets.  The arrival time stamps rise by one
step a packet from a fixed start, the stream's mux rate: its packets
spread over its duration.
"""

from __future__ import annotations

from . import split_annexb

FPS = (24000, 1001)
ATS_START = 0x2A0000
VIDEO_PID = 0x1011
PMT_PID = 0x0100
NULL_PACKET = b"\x47\x1f\xff\x10" + b"\xff" * 184
ALIGNED_UNIT = 32


def access_units(annexb: bytes) -> list:
    """The Annex-B stream's NAL units grouped into access units, each an
    Annex-B byte string: a picture starts at a slice with
    first_mb_in_slice 0 and takes the NAL units before it (parameter
    sets, SEI); what trails the last slice stays with the last unit."""
    units, pending = [], []
    for _, nal in split_annexb(annexb):
        t = nal[0] & 0x1F
        if 1 <= t <= 5 and (nal[1] & 0x80 or not units):
            units.append(pending + [nal])
            pending = []
        elif 1 <= t <= 5:
            units[-1].append(nal)
        else:
            pending.append(nal)
    if units:
        units[-1].extend(pending)
    return [b"".join(b"\x00\x00\x00\x01" + n for n in u) for u in units]


def mpeg_crc32(data: bytes) -> int:
    """CRC-32/MPEG-2 of a PSI section (ISO 13818-1 annex A)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _section(table_id: int, ext: int, body: bytes) -> bytes:
    """A PSI section with its pointer_field, header and CRC."""
    head = bytes([table_id, 0xB0 | (len(body) + 9) >> 8,
                  (len(body) + 9) & 0xFF, ext >> 8, ext & 0xFF, 0xC1, 0, 0])
    sec = head + body
    return b"\x00" + sec + mpeg_crc32(sec).to_bytes(4, "big")


def _ts_packet(pid: int, cc: int, payload: bytes, pusi: bool,
               pcr: int | None = None) -> bytes:
    """One 188-byte TS packet: `payload` (at most 184 bytes, 176 with a
    PCR), the adaptation field stuffing the rest and carrying the PCR
    (27 MHz) where given."""
    head = bytes([0x47, (0x40 if pusi else 0) | pid >> 8, pid & 0xFF])
    if pcr is None and len(payload) == 184:
        return head + bytes([0x10 | cc]) + payload
    af_len = 183 - len(payload)
    af = bytes([af_len])
    if af_len:
        opt = b""
        if pcr is not None:
            base, ext = pcr // 300, pcr % 300
            opt = ((base & 0x1FFFFFFFF) << 15 | 0x7E << 9 | ext).to_bytes(
                6, "big")
        af += bytes([0x50 if pcr is not None else 0]) + opt \
            + b"\xff" * (af_len - 1 - len(opt))
    return head + bytes([0x30 | cc]) + af + payload


def _encode_pts(ts):
    return bytes([
        (0b0010 << 4) | (((ts >> 30) & 7) << 1) | 1,
        (ts >> 22) & 0xFF,
        (((ts >> 15) & 0x7F) << 1) | 1,
        (ts >> 7) & 0xFF,
        ((ts & 0x7F) << 1) | 1])


def write(annexb: bytes, width: int, height: int) -> bytes:
    """The BDAV file of the Annex-B stream's access units (the module's
    docstring); the picture size is the stream's own."""
    aus = access_units(annexb)
    cc: dict = {}
    packets = []                     # (pid, cc, payload, pusi, pcr) or None

    def put(pid, payload, pusi, pcr=False):
        c = cc.get(pid, 0)
        cc[pid] = (c + 1) & 0xF
        packets.append((pid, c, payload, pusi, pcr))

    pat = _section(0x00, 0x0001, bytes([0x00, 0x01, 0xE0 | PMT_PID >> 8,
                                        PMT_PID & 0xFF]))
    pmt = _section(0x02, 0x0001, bytes(
        [0xE0 | VIDEO_PID >> 8, VIDEO_PID & 0xFF, 0xF0, 6])
        + b"\x05\x04HDMV" + bytes(
        [0x1B, 0xE0 | VIDEO_PID >> 8, VIDEO_PID & 0xFF, 0xF0, 0]))
    for k, au in enumerate(aus):
        put(0x0000, pat + b"\xff" * (184 - len(pat)), True)
        put(PMT_PID, pmt + b"\xff" * (184 - len(pmt)), True)
        pts = 90000 + k * 90000 * FPS[1] // FPS[0]
        pes = b"\x00\x00\x01\xe0\x00\x00\x80\x80\x05" + _encode_pts(pts) \
            + au
        put(VIDEO_PID, pes[:176], True, True)
        for off in range(176, len(pes), 184):
            put(VIDEO_PID, pes[off:off + 184], False)
    packets += [None] * (-len(packets) % ALIGNED_UNIT)
    n = len(packets)
    step = len(aus) * 27_000_000 * FPS[1] // FPS[0] // n
    out = bytearray()
    for i, p in enumerate(packets):
        ats = ATS_START + i * step
        out += (ats & 0x3FFFFFFF).to_bytes(4, "big")
        out += NULL_PACKET if p is None else _ts_packet(
            *p[:4], pcr=ats if p[4] else None)
    return bytes(out)

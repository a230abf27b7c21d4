"""MPEG Transport Stream demuxer.

Reference: minivideo/src/demuxer/mpeg/ts/ts.c is an empty stub (:40-71)
— the container is detected but unparseable.  This implementation goes
beyond the reference: it parses PAT/PMT, reassembles each elementary
PID's PES packets from the 188-byte transport packets (continuity,
adaptation fields, payload_unit_start boundaries), and indexes one
sample per PES unit.  Payload bytes are scattered across transport
packets, so samples carry per-fragment (offset, size) lists
(media.Track.fragments) and read_sample() reassembles them.

H.264 ES in TS is Annex-B, so mv_decode works end-to-end on TS files.
"""

from __future__ import annotations

import numpy as np

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace
from . import pes as P

TS_PACKET = 188

# PMT stream_type -> codec (ISO 13818-1 table 2-34 + common registrations)
_STREAM_TYPES = {
    0x01: (StreamType.VIDEO, Codec.MPEG1),
    0x02: (StreamType.VIDEO, Codec.MPEG2),
    0x03: (StreamType.AUDIO, Codec.MPEG_L2),
    0x04: (StreamType.AUDIO, Codec.MPEG_L2),
    0x0F: (StreamType.AUDIO, Codec.AAC),
    0x11: (StreamType.AUDIO, Codec.AAC),
    0x1B: (StreamType.VIDEO, Codec.H264),
    0x24: (StreamType.VIDEO, Codec.H265),
    0x81: (StreamType.AUDIO, Codec.AC3),
    0x87: (StreamType.AUDIO, Codec.EAC3),
    0x8A: (StreamType.AUDIO, Codec.DTS),
}


class _PesAcc:
    """Accumulates one PID's in-flight PES unit."""

    __slots__ = ("frags", "pts", "dts", "hdr")

    def __init__(self):
        self.frags = []
        self.pts = -1
        self.dts = -1
        self.hdr = b""          # first bytes, for the PES header parse


def ts_parse(media: MediaFile) -> bool:
    from ..bufio import FileWindow
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51); the
    # parse logic below is byte-identical to in-memory operation
    data = FileWindow(fh, media.file_size)
    n = len(data)

    pmt_pids: set[int] = set()
    es: dict[int, tuple] = {}            # pid -> (StreamType, Codec)
    acc: dict[int, _PesAcc] = {}
    samples: dict[int, list] = {}        # pid -> [(frags, size, pts, dts)]

    def close_pes(pid):
        a = acc.pop(pid, None)
        if a is None or not a.frags:
            return
        # strip the PES header from the first fragment
        if len(a.hdr) >= 9 and a.hdr[:3] == b"\x00\x00\x01":
            h = P.parse_pes_header(a.hdr, 0)
            a.pts, a.dts = h.pts, h.dts
            skip = h.header_size
            frags = []
            for off, sz in a.frags:
                if skip >= sz:
                    skip -= sz
                    continue
                frags.append((off + skip, sz - skip))
                skip = 0
            a.frags = frags
        size = sum(sz for _, sz in a.frags)
        if size > 0:
            samples.setdefault(pid, []).append(
                (a.frags, size, a.pts, a.dts))

    pos = 0
    while pos + TS_PACKET <= n:
        if data[pos] != 0x47:
            nxt = data.find(b"\x47", pos + 1)
            if nxt == -1:
                break
            pos = nxt
            continue
        b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
        pusi = bool(b1 & 0x40)
        pid = ((b1 & 0x1F) << 8) | b2
        afc = (b3 >> 4) & 3
        p = pos + 4
        if afc in (2, 3):                        # adaptation field
            p += 1 + data[p]
        if afc in (1, 3) and p < pos + TS_PACKET:
            end = pos + TS_PACKET
            if pid == 0:                         # PAT
                q = p + 1 + data[p]              # pointer_field
                sect_len = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
                stop = min(q + 3 + sect_len - 4, end)   # entries end @ CRC
                q += 8                           # table header
                while q + 4 <= stop:
                    prog = int.from_bytes(data[q:q + 2], "big")
                    mpid = ((data[q + 2] & 0x1F) << 8) | data[q + 3]
                    if prog != 0:
                        pmt_pids.add(mpid)
                    q += 4
            elif pid in pmt_pids:                # PMT
                q = p + 1 + data[p]
                sect_len = ((data[q + 1] & 0x0F) << 8) | data[q + 2]
                stop = min(q + 3 + sect_len - 4, end)
                pcr_skip = ((data[q + 10] & 0x0F) << 8) | data[q + 11]
                q += 12 + pcr_skip
                while q + 5 <= stop:
                    stype = data[q]
                    epid = ((data[q + 1] & 0x1F) << 8) | data[q + 2]
                    es_len = ((data[q + 3] & 0x0F) << 8) | data[q + 4]
                    q += 5 + es_len
                    if stype in _STREAM_TYPES and epid not in es:
                        es[epid] = _STREAM_TYPES[stype]
                        trace.info("TS", "PMT: PID 0x%04X stream_type "
                                   "0x%02X -> %s", epid, stype,
                                   es[epid][1].name)
            elif pid in es:
                if pusi:
                    close_pes(pid)
                    acc[pid] = _PesAcc()
                a = acc.get(pid)
                if a is not None:
                    a.frags.append((p, end - p))
                    if len(a.hdr) < 32:
                        a.hdr += data[p:end][:32 - len(a.hdr)]
        pos += TS_PACKET
    for pid in list(acc):
        close_pes(pid)

    ok = False
    for pid, (stype, codec) in es.items():
        units = samples.get(pid, [])
        if not units:
            continue
        t = Track(stream_type=stype, stream_codec=codec, track_id=pid)
        kinds = []
        for frags, size, _, _ in units:
            if stype == StreamType.VIDEO and codec == Codec.H264:
                head = b""
                for off, sz in frags[:2]:
                    head += data[off:off + sz]
                kinds.append(int(SampleType.VIDEO_SYNC)
                             if (b"\x00\x00\x01\x65" in head
                                 or b"\x00\x00\x01\x67" in head)
                             else int(SampleType.VIDEO))
            elif stype == StreamType.VIDEO:
                kinds.append(int(SampleType.VIDEO))
            else:
                kinds.append(int(SampleType.AUDIO))
        offs = [u[0][0][0] for u in units]
        sizes = [u[1] for u in units]
        pts = np.array([u[2] * 100000 // 9 if u[2] >= 0 else -1
                        for u in units], np.int64)
        dts = np.array([u[3] * 100000 // 9 if u[3] >= 0 else -1
                        for u in units], np.int64)
        t.set_samples(kinds, sizes, offs, pts, dts)
        t.fragments = [u[0] for u in units]
        t.compute_stats()
        media.add_track(t)
        ok = True
        trace.info("TS", "PID 0x%04X: %d PES units (%s)", pid,
                   len(units), codec.name)
    media.parsed = ok
    return ok

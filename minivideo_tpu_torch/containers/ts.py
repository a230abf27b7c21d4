"""MPEG Transport Stream demuxer.

Reference: minivideo/src/demuxer/mpeg/ts/ts.c is an empty stub (:40-71)
— the container is detected but unparseable.  This implementation goes
beyond the reference: it parses PAT/PMT, reassembles each elementary
PID's PES packets from the 188-byte transport packets (continuity,
adaptation fields, payload_unit_start boundaries), and indexes one
sample per PES unit.  Payload bytes are scattered across transport
packets, so samples carry per-fragment (offset, size) lists
(media.Track.fragments) and read_sample() reassembles them.

The packet size comes from the sync period: 188-byte TS packets, or
the 192-byte source packets of BDAV (Blu-ray .m2ts, AVCHD .mts), a
4-byte TP_extra_header (copy permission, arrival time stamp) before
each TS packet.  Packets are walked at that stride; only where the sync
byte is missing there does the walk resync, to the next 0x47 whose
period holds (the last of a header's run of them), so a 0x47 inside a
header is never taken for a packet.
Null packets (PID 0x1FFF) are skipped.  The walk is one `demux.ts` span
(profiling.span): items the packets, bytes the file's, and its note the
packet size and the null and resync counts; demux.cc walks the same way.

H.264 ES in TS is Annex-B, so mv_decode works end-to-end on TS files.
"""

from __future__ import annotations

import numpy as np

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace
from . import pes as P

TS_PACKET = 188
TS_SYNCS = 4        # syncs, one stride apart, that make a period
NULL_PID = 0x1FFF

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


def ts_period(data, q: int) -> int:
    """The packet size from the sync period at q (data[q] == 0x47): 188
    where 0x47 also stands TS_SYNCS - 1 further strides of 188 on, 192
    (BDAV) where it does at strides of 192, else 0.  Strides past the
    end of `data` are not asked for."""
    n = len(data)
    for stride in (188, 192):
        if stride == 192 and q < 4:
            break
        if all(data[q + k * stride] == 0x47 for k in range(1, TS_SYNCS)
               if q + k * stride < n):
            return stride
    return 0


def ts_parse(media: MediaFile) -> bool:
    from ..bufio import FileWindow
    from ..profiling import span
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51); the
    # parse logic below is byte-identical to in-memory operation
    data = FileWindow(fh, media.file_size)
    with span("demux.ts", nbytes=len(data)) as s:
        ok, counts = _walk(media, data)
        s.note(items=counts[1], packet_size=counts[0], nulls=counts[2],
               resyncs=counts[3])
    return ok


def _walk(media: MediaFile, data):
    """Demux the TS in `data` into `media`'s tracks: (ok, [packet size,
    packets, null packets, resyncs])."""
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

    def resync(start):
        """(stride, first source packet) of the next 0x47 from `start`
        whose period holds, or (0, n).  A 0x47 in the TP_extra_header of
        every packet holds a 192 period as well, so of the 192 periods
        at q..q+4 the last is the TS sync."""
        q = data.find(b"\x47", start)
        while q != -1:
            stride = ts_period(data, q)
            if stride == 192:
                q += next((j for j in range(4, 0, -1) if q + j < n
                           and data[q + j] == 0x47
                           and ts_period(data, q + j) == 192), 0)
            if stride:
                return stride, q - (stride - TS_PACKET)
            q = data.find(b"\x47", q + 1)
        return 0, n

    # source packets of `stride` bytes, each ending in its TS packet
    if n > 0 and data[0] == 0x47 and ts_period(data, 0) == 188:
        stride, pos = 188, 0
    elif n > 4 and data[4] == 0x47 and ts_period(data, 4) == 192:
        stride, pos = 192, 0
    else:
        stride, pos = resync(0)
    counts = [stride, 0, 0, 0]
    while stride and pos + stride <= n:
        ts = pos + stride - TS_PACKET
        if data[ts] != 0x47:
            counts[3] += 1
            stride, pos = resync(ts + 1)
            continue
        counts[1] += 1
        b1, b2, b3 = data[ts + 1], data[ts + 2], data[ts + 3]
        pusi = bool(b1 & 0x40)
        pid = ((b1 & 0x1F) << 8) | b2
        afc = (b3 >> 4) & 3
        p = ts + 4
        end = ts + TS_PACKET
        if pid == NULL_PID:
            counts[2] += 1
            pos += stride
            continue
        if afc in (2, 3):                        # adaptation field
            p += 1 + data[p]
        if afc in (1, 3) and p < end:
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
        pos += stride
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
    return ok, counts

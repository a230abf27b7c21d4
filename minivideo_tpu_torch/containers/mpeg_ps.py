"""MPEG Program Stream demuxer.

Reference: minivideo/src/demuxer/mpeg/ps/ps.c — PES-packet loop keyed on
stream_id (:308-485): pack header (:50), system header (:147), PSM
(:196), audio 0xC0-0xDF / private-1, video 0xE0-0xEF; per packet the
payload (offset/size/PTS/DTS) is appended to the track's sample table.

An H.264 stream differs from the reference by design: its samples are
access units, not PES packets.  The reference makes each packet a sample,
so an access unit split over packets (a 1080p picture is larger than
the 16-bit PES_packet_length allows; DVD muxers write 2,048-byte packs
that ignore picture boundaries) reaches the decoder cut to its first
packet.  Here the payloads of one stream are read as one Annex-B stream
and split at the access unit boundaries of H.264 §7.4.1.2.3; a sample
whose bytes lie in several packets keeps them as Track.fragments.  Where
every packet holds one whole access unit, the table is the reference's.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace
from . import pes as P


def ps_parse(media: MediaFile) -> bool:
    from ..bufio import FileWindow
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51); the
    # parse logic below is byte-identical to in-memory operation
    data = FileWindow(fh, media.file_size)
    n = len(data)
    audio = {}   # stream_id -> list of (off, size, pts, dts)
    video = {}
    stats = {"pack": 0, "system": 0, "psm": 0, "audio": 0, "video": 0,
             "private": 0}

    pos = data.find(b"\x00\x00\x01")
    while pos != -1 and pos + 4 <= n:
        sid = data[pos + 3]
        if sid == P.SID_PACK_HEADER:
            stats["pack"] += 1
            # MPEG-2 pack header: 10 bytes + stuffing; MPEG-1: 8 bytes
            if pos + 14 <= n and (data[pos + 4] >> 6) == 0b01:
                stuffing = data[pos + 13] & 7
                pos += 14 + stuffing
            else:
                pos += 12
        elif sid == P.SID_SYSTEM_HEADER:
            stats["system"] += 1
            ln = (data[pos + 4] << 8) | data[pos + 5]
            pos += 6 + ln
        elif sid == P.SID_PSM:
            stats["psm"] += 1
            ln = (data[pos + 4] << 8) | data[pos + 5]
            pos += 6 + ln
        elif sid == P.SID_PROGRAM_END:
            break
        elif (P.SID_AUDIO_FIRST <= sid <= P.SID_AUDIO_LAST
              or sid == P.SID_PRIVATE_1):
            h = P.parse_pes_header(data, pos)
            stats["audio" if sid != P.SID_PRIVATE_1 else "private"] += 1
            off = pos + h.header_size
            size = max(0, h.payload_size)
            audio.setdefault(sid, []).append((off, size, h.pts, h.dts))
            pos += 6 + h.packet_length
        elif P.SID_VIDEO_FIRST <= sid <= P.SID_VIDEO_LAST:
            h = P.parse_pes_header(data, pos)
            stats["video"] += 1
            off = pos + h.header_size
            size = max(0, h.payload_size)
            video.setdefault(sid, []).append((off, size, h.pts, h.dts))
            pos += 6 + h.packet_length
        elif sid == P.SID_PADDING:
            ln = (data[pos + 4] << 8) | data[pos + 5]
            pos += 6 + ln
        else:
            pos += 4
        nxt = data.find(b"\x00\x00\x01", pos)
        pos = nxt

    ok = False
    for sid, packets in video.items():
        vinfo = _sniff_video(data, packets)
        if vinfo.codec == Codec.H264:
            units = _h264_access_units(data, packets)
            t = _make_track([(runs[0][0], sum(sz for _, sz in runs), pts,
                              dts) for runs, _, pts, dts in units],
                            StreamType.VIDEO, vinfo.codec)
            t.sample_type[np.array([u[1] for u in units], bool)] = int(
                SampleType.VIDEO_SYNC)
            if any(len(u[0]) > 1 for u in units):
                t.fragments = [u[0] for u in units]
        else:
            t = _make_track(packets, StreamType.VIDEO, vinfo.codec)
        t.width, t.height = vinfo.width, vinfo.height
        t.dar = vinfo.dar
        if vinfo.framerate:
            t.framerate = vinfo.framerate
            t.framerate_num = vinfo.framerate_num
            t.framerate_base = vinfo.framerate_base
        t.compute_stats()
        media.add_track(t)
        ok = True
        trace.info("PS", "video stream 0x%02X: %d PES packets, %d "
                   "samples %dx%d @ %.3f fps", sid, len(packets),
                   t.sample_count, t.width, t.height, t.framerate)
    for sid, packets in audio.items():
        ainfo = _sniff_audio(data, packets, sid == P.SID_PRIVATE_1)
        t = _make_track(packets, StreamType.AUDIO, ainfo.codec)
        t.sampling_rate = ainfo.sampling_rate
        t.channel_count = ainfo.channels
        t.sample_per_frames = ainfo.extra.get("sample_per_frames", 0)
        t.compute_stats()
        if not t.bitrate and ainfo.bitrate:
            t.bitrate = ainfo.bitrate      # nominal, from the ES header
        media.add_track(t)
        ok = True
        trace.info("PS", "audio stream 0x%02X: %d PES packets %s "
                   "%d Hz", sid, len(packets), ainfo.codec.name,
                   t.sampling_rate)
    trace.t1("PS", "stats: %s", stats)
    media.parsed = ok
    return ok


def _make_track(packets, stype, codec) -> Track:
    t = Track(stream_type=stype, stream_codec=codec)
    offs = [p[0] for p in packets]
    sizes = [p[1] for p in packets]
    # PTS/DTS: 90 kHz -> ns
    pts = np.array([p[2] * 100000 // 9 if p[2] >= 0 else -1
                    for p in packets], dtype=np.int64)
    dts = np.array([p[3] * 100000 // 9 if p[3] >= 0 else -1
                    for p in packets], dtype=np.int64)
    kinds = ([int(SampleType.VIDEO)] * len(offs)
             if stype == StreamType.VIDEO
             else [int(SampleType.AUDIO)] * len(offs))
    t.set_samples(kinds, sizes, offs, pts, dts)
    t.compute_stats()
    return t


# NAL unit types that open a new access unit once the current one holds
# a slice (H.264 §7.4.1.2.3): SEI, SPS, PPS, access unit delimiter, 14-18
_AU_OPENERS = frozenset((6, 7, 8, 9, 14, 15, 16, 17, 18))


def _h264_access_units(data, packets) -> list:
    """Split one H.264 stream's PES payloads into access units.

    The payloads, in order, are one Annex-B stream; the start-code search
    runs over their concatenation, so a start code cut between two
    packets is found.  A new access unit begins at the first opener NAL
    (_AU_OPENERS) or at the first slice with first_mb_in_slice 0 that
    follows a slice of the current one.  It begins at its start code,
    or one byte earlier where a zero byte precedes the start code in the
    same packet (a 4-byte start code); the first begins at the first
    payload byte.  Returns one (runs, idr, pts, dts) per access unit:
    runs its [(file offset, size)], idr whether it holds a NAL of type
    5, pts/dts those of the packet holding its first byte."""
    runs = [(off, size, k) for k, (off, size, _, _) in enumerate(packets)
            if size > 0]
    es_start = []                 # stream position of each run's 1st byte
    total = 0
    for _, size, _ in runs:
        es_start.append(total)
        total += size
    if not total:
        return []
    starts, idr = [0], [False]
    vcl = False                   # the current access unit holds a slice
    tail = b""
    for r, (off, size, _) in enumerate(runs):
        chunk = data[off:off + size]
        # a payload cut by the file's end reads as zeros, as in demux.cc
        buf = tail + chunk + bytes(size - len(chunk))
        base = es_start[r] - len(tail)
        need = 5 if r + 1 < len(runs) else 4   # header, first_mb byte
        i = buf.find(b"\x00\x00\x01")
        while i != -1 and i + need <= len(buf):
            pos = base + i
            ntype = buf[i + 3] & 0x1F
            new = False
            if ntype in _AU_OPENERS:
                new, vcl = vcl, False
            elif ntype in (1, 2, 5):
                # first_mb_in_slice is ue(v): 0 codes as a leading '1'
                first_mb_zero = i + 4 < len(buf) and buf[i + 4] & 0x80
                new, vcl = vcl and bool(first_mb_zero), True
            if new:
                if (i > 0 and buf[i - 1] == 0 and pos - 1
                        >= es_start[bisect_right(es_start, pos) - 1]):
                    pos -= 1
                starts.append(pos)
                idr.append(False)
            if ntype == 5:
                idr[-1] = True
            i = buf.find(b"\x00\x00\x01", i + 3)
        tail = buf[max(i - 1, 0):] if i != -1 else buf[-3:]
    units = []
    for j, s in enumerate(starts):
        e = starts[j + 1] if j + 1 < len(starts) else total
        k = bisect_right(es_start, s) - 1
        first = runs[k][2]
        au = []
        while k < len(runs) and es_start[k] < e:
            off, size, _ = runs[k]
            a = max(s, es_start[k])
            b = min(e, es_start[k] + size)
            au.append((off + a - es_start[k], b - a))
            k += 1
        units.append((au, idr[j], packets[first][2], packets[first][3]))
    return units


def _sniff_video(data, packets) -> P.EsVideoInfo:
    """ES metadata from the first sniffable video payload (reference
    parse_pes_v only inspects packets carrying a PTS — sample-aligned
    payload starts; pes.c:992-996)."""
    best = P.EsVideoInfo()
    for off, size, pts, _ in packets[:32]:
        if pts < 0 or size <= 0:
            continue
        info = P.sniff_video_es(data[off:off + min(size, 256)])
        if info.codec != Codec.UNKNOWN:
            if best.codec == Codec.UNKNOWN:
                best = info
            if info.width:
                return info
    if best.codec == Codec.UNKNOWN:
        best.codec = Codec.MPEG2          # reference default assumption
    return best


def _sniff_audio(data, packets, private: bool) -> P.EsAudioInfo:
    """ES metadata from the first sniffable audio payload (reference
    parse_pes_a, pes.c:645-980)."""
    for off, size, _, _ in packets[:32]:
        if size <= 0:
            continue
        info = P.sniff_audio_es(data[off:off + min(size, 64)], private)
        if info.codec != Codec.UNKNOWN:
            return info
    fallback = P.EsAudioInfo()
    fallback.codec = Codec.AC3 if private else Codec.MPEG_L2
    return fallback

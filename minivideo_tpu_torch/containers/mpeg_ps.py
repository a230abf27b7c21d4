"""MPEG Program Stream demuxer.

Reference: minivideo/src/demuxer/mpeg/ps/ps.c — PES-packet loop keyed on
stream_id (:308-485): pack header (:50), system header (:147), PSM
(:196), audio 0xC0-0xDF / private-1, video 0xE0-0xEF; per packet the
payload (offset/size/PTS/DTS) is appended to the track's sample table.
"""

from __future__ import annotations

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
        t = _make_track(packets, StreamType.VIDEO, vinfo.codec)
        t.width, t.height = vinfo.width, vinfo.height
        t.dar = vinfo.dar
        if vinfo.framerate:
            t.framerate = vinfo.framerate
            t.framerate_num = vinfo.framerate_num
            t.framerate_base = vinfo.framerate_base
        if vinfo.codec == Codec.H264:
            # mark IDR-bearing packets as sync samples
            for j, (off, size, _, _) in enumerate(packets):
                chunk = data[off:off + min(size, 4096)]
                if (b"\x00\x00\x01\x65" in chunk
                        or b"\x00\x00\x01\x25" in chunk):
                    t.sample_type[j] = int(SampleType.VIDEO_SYNC)
        t.compute_stats()
        media.add_track(t)
        ok = True
        trace.info("PS", "video stream 0x%02X: %d PES packets %dx%d "
                   "@ %.3f fps", sid, len(packets), t.width, t.height,
                   t.framerate)
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

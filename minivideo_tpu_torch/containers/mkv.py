"""Matroska / EBML demuxer.

Reference: minivideo/src/demuxer/mkv/{ebml.c,mkv.c} — EBML header and
vint readers (:37-230), segment walk recognizing SeekHead/Info/Tracks/
Cluster/Cues but extracting NOTHING (mkv.c:39-197; not even wired into
minivideo_parse).  This implementation goes well beyond the reference:
it parses Info (TimestampScale), TrackEntry metadata (codec id,
video/audio params, avcC CodecPrivate -> SPS/PPS) AND indexes every
Cluster's SimpleBlock/BlockGroup frames into the sample table — all
four lacing modes — so MKV H.264 tracks decode end-to-end.
"""

from __future__ import annotations

import numpy as np

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace

_CODEC_IDS = {
    "V_MPEG4/ISO/AVC": Codec.H264,
    "V_MPEGH/ISO/HEVC": Codec.H265,
    "V_MPEG4/ISO/ASP": Codec.MPEG4_ASP,
    "V_MPEG2": Codec.MPEG2,
    "V_MPEG1": Codec.MPEG1,
    "V_VP8": Codec.VP8,
    "V_VP9": Codec.VP9,
    "V_THEORA": Codec.VP4,
    "A_AAC": Codec.AAC,
    "A_MPEG/L3": Codec.MPEG_L3,
    "A_MPEG/L2": Codec.MPEG_L2,
    "A_AC3": Codec.AC3,
    "A_EAC3": Codec.EAC3,
    "A_DTS": Codec.DTS,
    "A_VORBIS": Codec.VORBIS,
    "A_OPUS": Codec.OPUS,
    "A_FLAC": Codec.FLAC,
    "A_PCM/INT/LIT": Codec.LPCM,
}


def _read_vint(data, pos, strip_marker=True):
    """EBML variable-size integer (reference read_ebml_eid/size,
    ebml.c:121-230).  Returns (value, nbytes) or (None, 0)."""
    if pos >= len(data):
        return None, 0
    first = data[pos]
    if first == 0:
        return None, 0
    length = 9 - first.bit_length()
    if pos + length > len(data):
        return None, 0
    value = first
    if strip_marker:
        value &= (1 << (8 - length)) - 1
    for i in range(1, length):
        value = (value << 8) | data[pos + i]
    return value, length


def _iter_elements(data, start, end):
    pos = start
    while pos < end:
        eid, n1 = _read_vint(data, pos, strip_marker=False)
        if eid is None:
            return
        size, n2 = _read_vint(data, pos + n1, strip_marker=True)
        if size is None:
            return
        payload = pos + n1 + n2
        yield eid, payload, min(payload + size, end)
        pos = payload + size


def _uint(data, start, end):
    v = 0
    for i in range(start, end):
        v = (v << 8) | data[i]
    return v


def mkv_parse(media: MediaFile) -> bool:
    from ..bufio import FileWindow
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51)
    data = FileWindow(fh, media.file_size)
    if data[0:4] != b"\x1a\x45\xdf\xa3":
        return False
    ok = False
    for eid, start, end in _iter_elements(data, 0, len(data)):
        if eid == 0x1A45DFA3:        # EBML header
            for sid, s, e in _iter_elements(data, start, end):
                if sid == 0x4282:    # DocType
                    trace.info("MKV", "DocType: %s",
                               data[s:e].decode("latin-1", "replace"))
        elif eid == 0x18538067:      # Segment
            ok = _parse_segment(data, start, end, media) or ok
    media.parsed = ok
    return ok


def _parse_segment(data, start, end, media) -> bool:
    found = False
    timescale = 1_000_000            # ns per tick (Matroska default)
    tracks: dict[int, Track] = {}    # TrackNumber -> Track
    samples: dict[int, list] = {}    # TrackNumber -> [(off, sz, pts, key)]
    for eid, s, e in _iter_elements(data, start, end):
        if eid == 0x1549A966:        # Info
            for sid, ss, se in _iter_elements(data, s, e):
                if sid == 0x2AD7B1:  # TimestampScale
                    timescale = _uint(data, ss, se) or timescale
                    trace.t1("MKV", "timescale %d ns", timescale)
        elif eid == 0x1654AE6B:      # Tracks
            for sid, ss, se in _iter_elements(data, s, e):
                if sid == 0xAE:      # TrackEntry
                    t = _parse_track_entry(data, ss, se)
                    if t is not None:
                        tracks[t.track_id] = t
                        samples[t.track_id] = []
                        found = True
        elif eid == 0x1F43B675:      # Cluster
            _parse_cluster(data, s, e, samples)

    for tn, t in tracks.items():
        blocks = samples.get(tn, ())
        if blocks:
            if t.stream_type == StreamType.VIDEO:
                kinds = [int(SampleType.VIDEO_SYNC) if k
                         else int(SampleType.VIDEO)
                         for _, _, _, k in blocks]
            elif t.stream_type == StreamType.AUDIO:
                kinds = [int(SampleType.AUDIO)] * len(blocks)
            else:
                kinds = [int(SampleType.OTHER)] * len(blocks)
            offs = [b[0] for b in blocks]
            sizes = [b[1] for b in blocks]
            pts = np.array([b[2] * timescale for b in blocks], np.int64)
            t.set_samples(kinds, sizes, offs, pts, pts)
            t.compute_stats()
        media.add_track(t)
    return found


def _parse_cluster(data, start, end, samples) -> None:
    """Index one Cluster's frames (SimpleBlock 0xA3 / BlockGroup 0xA0).

    Offsets/sizes point at the raw frame bytes inside the block (after
    the block header and lacing table), so read_sample() returns exactly
    one codec frame."""
    cluster_ts = 0
    for eid, s, e in _iter_elements(data, start, end):
        if eid == 0xE7:              # Cluster Timestamp
            cluster_ts = _uint(data, s, e)
        elif eid == 0xA3:            # SimpleBlock
            _parse_block(data, s, e, cluster_ts, samples, keyed=True)
        elif eid == 0xA0:            # BlockGroup
            has_ref = False
            block = None
            for gid, gs, ge in _iter_elements(data, s, e):
                if gid == 0xA1:      # Block
                    block = (gs, ge)
                elif gid == 0xFB:    # ReferenceBlock -> not a keyframe
                    has_ref = True
            if block is not None:
                _parse_block(data, block[0], block[1], cluster_ts,
                             samples, keyed=False, keyframe=not has_ref)


def _parse_block(data, start, end, cluster_ts, samples, keyed,
                 keyframe=False) -> None:
    """(Simple)Block: vint TrackNumber, s16 relative timestamp, flags,
    optional lacing table, then 1..n frames."""
    tn, n1 = _read_vint(data, start)
    if tn is None or start + n1 + 3 > end:
        return
    p = start + n1
    rel = int.from_bytes(data[p:p + 2], "big", signed=True)
    flags = data[p + 2]
    p += 3
    if keyed:
        keyframe = bool(flags & 0x80)
    lacing = (flags >> 1) & 3
    ts = cluster_ts + rel
    lst = samples.get(tn)
    if lst is None:
        return
    if lacing == 0:                  # no lacing: one frame
        lst.append((p, end - p, ts, keyframe))
        return
    if p >= end:
        return
    nframes = data[p] + 1
    p += 1
    sizes = []
    if lacing == 2:                  # fixed-size lacing
        if nframes and (end - p) % nframes == 0:
            sizes = [(end - p) // nframes] * nframes
    elif lacing == 1:                # Xiph lacing
        sizes = []
        for _ in range(nframes - 1):
            sz = 0
            while p < end:
                sz += data[p]
                stop = data[p] != 255
                p += 1
                if stop:
                    break
            sizes.append(sz)
        sizes.append(end - p - sum(sizes))
    else:                            # EBML lacing
        first, n = _read_vint(data, p)
        if first is None:
            return
        p += n
        sizes = [first]
        for _ in range(nframes - 2):
            delta, n = _read_vint(data, p)
            if delta is None:
                return
            p += n
            # signed vint: stored value minus (2^(7*n-1) - 1)
            delta -= (1 << (7 * n - 1)) - 1
            sizes.append(sizes[-1] + delta)
        if nframes >= 2:
            sizes.append(end - p - sum(sizes))
    for sz in sizes:
        if sz < 0 or p + sz > end:
            trace.warning("MKV", "bad lacing in block at %d", start)
            return
        lst.append((p, sz, ts, keyframe))
        p += sz


def _parse_avcc_bytes(t: Track, blob: bytes) -> None:
    """avcC CodecPrivate -> SPS/PPS parameter sets + NALU length size
    (same record as mp4 avcC, mp4.c:1857-1929)."""
    if len(blob) < 7 or blob[0] != 1:
        return
    t.nal_length_size = (blob[4] & 0x3) + 1
    t.length_prefixed = True
    p = 5
    n_sps = blob[p] & 0x1F
    p += 1
    for _ in range(n_sps):
        ln = int.from_bytes(blob[p:p + 2], "big")
        p += 2
        t.parameter_sets.append(blob[p:p + ln])
        p += ln
    if p < len(blob):
        n_pps = blob[p]
        p += 1
        for _ in range(n_pps):
            ln = int.from_bytes(blob[p:p + 2], "big")
            p += 2
            t.parameter_sets.append(blob[p:p + ln])
            p += ln


def _parse_track_entry(data, start, end) -> Track:
    import struct
    t = Track()
    ttype = 0
    codec_private = b""
    for eid, s, e in _iter_elements(data, start, end):
        if eid == 0xD7:              # TrackNumber
            t.track_id = _uint(data, s, e)
        elif eid == 0x83:            # TrackType
            ttype = _uint(data, s, e)
        elif eid == 0x86:            # CodecID
            cid = data[s:e].decode("latin-1", "replace").rstrip("\x00")
            t.stream_codec = _CODEC_IDS.get(cid, Codec.UNKNOWN)
        elif eid == 0x63A2:          # CodecPrivate
            codec_private = data[s:e]
        elif eid == 0xE0:            # Video
            for vid, vs, ve in _iter_elements(data, s, e):
                if vid == 0xB0:
                    t.width = _uint(data, vs, ve)
                elif vid == 0xBA:
                    t.height = _uint(data, vs, ve)
        elif eid == 0xE1:            # Audio
            for aid, as_, ae in _iter_elements(data, s, e):
                if aid == 0x9F:
                    t.channel_count = _uint(data, as_, ae)
                elif aid == 0xB5:    # SamplingFrequency (float)
                    raw = data[as_:ae]
                    if len(raw) == 4:
                        t.sampling_rate = int(struct.unpack(">f", raw)[0])
                    elif len(raw) == 8:
                        t.sampling_rate = int(struct.unpack(">d", raw)[0])
                elif aid == 0x6264:  # BitDepth
                    t.bit_per_sample = _uint(data, as_, ae)
    t.stream_type = {1: StreamType.VIDEO, 2: StreamType.AUDIO,
                     17: StreamType.TEXT}.get(ttype, StreamType.UNKNOWN)
    if codec_private:
        if t.stream_codec == Codec.H264:
            _parse_avcc_bytes(t, codec_private)
        else:
            t.parameter_sets.append(codec_private)
    trace.info("MKV", "track %d: %s %s", t.track_id, t.stream_type.name,
               t.stream_codec.name)
    return t

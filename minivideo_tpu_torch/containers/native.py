"""Native (C++) demuxer front-end.

Calls the demux entry points of native/src/demux.cc (built at first use
into the package's `_build/` as its own library, native.load_demux; a
failed build raises) and rebuilds the same Track objects the Python
demuxers produce.  The raw table expansion (the O(samples) hot path,
reference convertTrack mp4.c:160-545) runs in C++; cheap derivations
that must match the Python demuxers bit-for-bit (ns rescaling,
framerate, synthesized PTS, stats) run here with the exact same numpy
expressions.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..codecs import (BitrateMode, Codec, Container, SampleType, StreamType,
                      WAVE_FORMAT_TO_CODEC, codec_from_fourcc)
from ..media import MediaFile, Track
from .. import trace

_NATIVE_CONTAINERS = {Container.MP4, Container.AVI, Container.WAVE,
                      Container.MPEG_PS, Container.ES, Container.ES_MP3,
                      Container.MKV, Container.MPEG_TS}


def _bind(lib):
    if getattr(lib, "_demux_bound", False):
        return lib
    lib.mv_demux_parse.restype = ctypes.c_void_p
    lib.mv_demux_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.mv_demux_track_count.restype = ctypes.c_int32
    lib.mv_demux_track_count.argtypes = [ctypes.c_void_p]
    lib.mv_demux_track_info.restype = ctypes.c_int32
    lib.mv_demux_track_info.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                        ctypes.POINTER(ctypes.c_int64)]
    lib.mv_demux_track_tables.restype = ctypes.c_int32
    lib.mv_demux_track_tables.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.mv_demux_track_psets.restype = ctypes.c_int64
    lib.mv_demux_track_psets.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_void_p, ctypes.c_int64]
    lib.mv_demux_track_frags.restype = ctypes.c_int32
    lib.mv_demux_track_frags.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mv_demux_ts_counts.restype = ctypes.c_int32
    lib.mv_demux_ts_counts.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.mv_demux_close.restype = None
    lib.mv_demux_close.argtypes = [ctypes.c_void_p]
    lib._demux_bound = True
    return lib


def native_demux_available(container: Container) -> bool:
    """Whether demux.cc parses `container`.  Unlike the JAX package, this
    does not ask whether the library loads: native_demux builds it and a
    failed build raises."""
    return container in _NATIVE_CONTAINERS


def native_demux(media: MediaFile) -> bool:
    """Parse `media` with the native demuxer; returns False on failure
    (caller falls back to the Python demuxers)."""
    from ..native import load_demux
    lib = _bind(load_demux())
    if media.container == Container.MPEG_TS:
        h = _parse_ts(lib, media)
    else:
        h = lib.mv_demux_parse(media.file_path.encode(),
                               int(media.container))
    if not h:
        trace.t1("DEMUX", "native demux found no tracks")
        return False
    try:
        n_tracks = lib.mv_demux_track_count(h)
        ok = False
        for ti in range(n_tracks):
            info = (ctypes.c_int64 * 24)()
            if lib.mv_demux_track_info(h, ti, info) != 0:
                continue
            n = int(info[13])
            types = np.zeros(n, np.int32)
            sizes = np.zeros(n, np.int64)
            offs = np.zeros(n, np.int64)
            pts = np.zeros(n, np.int64)
            dts = np.zeros(n, np.int64)
            lib.mv_demux_track_tables(
                h, ti,
                types.ctypes.data_as(ctypes.c_void_p),
                sizes.ctypes.data_as(ctypes.c_void_p),
                offs.ctypes.data_as(ctypes.c_void_p),
                pts.ctypes.data_as(ctypes.c_void_p),
                dts.ctypes.data_as(ctypes.c_void_p))
            psets = []
            if info[14] > 0:
                buf = (ctypes.c_uint8 * int(info[14]))()
                ln = lib.mv_demux_track_psets(h, ti, buf, int(info[14]))
                raw = bytes(buf[:ln])
                p = 0
                while p + 2 <= len(raw):
                    ln2 = (raw[p] << 8) | raw[p + 1]
                    p += 2
                    psets.append(raw[p:p + ln2])
                    p += ln2
            frags = None
            if (media.container in (Container.MPEG_TS, Container.MPEG_PS)
                    and info[19] > 0):
                # TS, and PS access units split over PES packets:
                # scattered payload fragments (info[19] = count)
                fo = np.zeros(int(info[19]), np.int64)
                fs_ = np.zeros(int(info[19]), np.int64)
                fc = np.zeros(n, np.int32)
                lib.mv_demux_track_frags(
                    h, ti, fo.ctypes.data_as(ctypes.c_void_p),
                    fs_.ctypes.data_as(ctypes.c_void_p),
                    fc.ctypes.data_as(ctypes.c_void_p))
                # one list of (offset, size) a sample, built at C speed:
                # a 1080p BDAV file holds ~10,500 fragments
                pairs = list(zip(fo.tolist(), fs_.tolist()))
                ends = np.cumsum(fc).tolist()
                frags = [pairs[a:b] for a, b in zip([0] + ends[:-1], ends)]
            t = _build_track(media.container, info, types, sizes, offs,
                             pts, dts, psets, frags)
            if t is not None:
                if media.container == Container.MPEG_PS:
                    _sniff_ps_metadata(media, t, int(info[9]) == 0xBD)
                elif media.container == Container.WAVE:
                    _attach_wave_metadata(media, t)
                media.add_track(t)
                ok = True
        media.parsed = ok
        return ok
    finally:
        lib.mv_demux_close(h)


def _parse_ts(lib, media: MediaFile):
    """mv_demux_parse of a TS file as one `demux.ts` span: items the
    packets walked, bytes the file's, its note the packet size (188, or
    192 for BDAV) and the null packet and resync counts of the walk."""
    from ..profiling import span
    with span("demux.ts", nbytes=media.file_size) as s:
        h = lib.mv_demux_parse(media.file_path.encode(),
                               int(Container.MPEG_TS))
        if h:
            c = (ctypes.c_int64 * 4)()
            lib.mv_demux_ts_counts(h, c)
            s.note(items=c[1], packet_size=c[0], nulls=c[2], resyncs=c[3])
    return h


def _sniff_ps_metadata(media: MediaFile, t: Track, private: bool) -> None:
    """ES metadata for native-demuxed PS tracks: the byte-level sniffers
    (containers/pes.py sniff_audio_es / sniff_video_es) are shared with
    the Python demuxer so both paths report identical
    dimensions/DAR/framerate/rates; only a few payload heads are read."""
    from .pes import sniff_audio_es, sniff_video_es
    fh = media.file_handle
    for j in range(min(t.sample_count, 32)):
        size = int(t.sample_size[j])
        if size <= 0:
            continue
        fh.seek(int(t.sample_offset[j]))
        head = fh.read(min(size, 256))
        if t.stream_type == StreamType.VIDEO:
            if int(t.sample_pts[j]) < 0:
                continue
            info = sniff_video_es(head)
            if info.width:
                t.width, t.height = info.width, info.height
                t.dar = info.dar
                if info.framerate:
                    t.framerate = info.framerate
                    t.framerate_num = info.framerate_num
                    t.framerate_base = info.framerate_base
                t.compute_stats()
                return
        else:
            info = sniff_audio_es(head, private)
            if info.codec != Codec.UNKNOWN:
                t.stream_codec = info.codec   # header beats stream-id guess
                t.sampling_rate = info.sampling_rate
                t.channel_count = info.channels
                t.sample_per_frames = info.extra.get(
                    "sample_per_frames", 0)
                t.compute_stats()
                if not t.bitrate and info.bitrate:
                    t.bitrate = info.bitrate
                return


def _attach_wave_metadata(media: MediaFile, t: Track) -> None:
    """fmt-extension dict + cue points for native-demuxed WAVE tracks:
    the chunk scanners (containers/wave.py _parse_fmt/_parse_cue) are
    shared with the Python demuxer so both paths surface identical
    metadata; only the small header chunks are re-read."""
    import struct
    from .riff import iter_chunks
    from .wave import _parse_cue, _parse_fmt
    fh = media.file_handle
    fh.seek(0)
    hdr = fh.read(12)
    if len(hdr) < 12:
        return
    end = min(8 + struct.unpack("<I", hdr[4:8])[0], media.file_size)
    t.wave_fmt = {}
    t.wave_cue_points = []
    for fcc, _lt, size, off in iter_chunks(fh, end):
        if fcc == b"fmt ":
            fh.seek(off)
            t.wave_fmt = _parse_fmt(fh.read(min(size, 64)))
        elif fcc == b"cue ":
            fh.seek(off)
            t.wave_cue_points = _parse_cue(fh.read(min(size, 4 + 24 * 1024)))


def _resolve_codec(info) -> Codec:
    mode, key = int(info[3]), int(info[2])
    if mode == 1:                           # fourcc map
        c = codec_from_fourcc(key)
        if c == Codec.UNKNOWN and info[18]:
            c = codec_from_fourcc(int(info[18]))
        return c
    if mode == 2:                           # WAVE wFormatTag map
        return WAVE_FORMAT_TO_CODEC.get(key, Codec.UNKNOWN)
    if mode == 3:                           # direct Codec id
        try:
            return Codec(key)
        except ValueError:
            return Codec.UNKNOWN
    return Codec.UNKNOWN


def _build_track(container, info, types, sizes, offs, pts, dts,
                 psets, frags=None) -> Track | None:
    n = len(types)
    stream_type = StreamType(int(info[0]))
    t = Track(
        stream_type=stream_type, stream_fcc=int(info[1]),
        stream_codec=_resolve_codec(info),
        width=int(info[4]), height=int(info[5]),
        channel_count=int(info[6]), sampling_rate=int(info[7]),
        bit_per_sample=int(info[8]), track_id=int(info[9]),
        timescale=int(info[10]), duration_units=int(info[11]),
        nal_length_size=int(info[12]) or 4,
        parameter_sets=psets, sample_per_frames=int(info[15]),
    )

    if container == Container.MP4:
        # visual-extension metadata packed by demux.cc mp4_convert
        t.par_h = int(info[19]) >> 32 or 1
        t.par_v = int(info[19]) & 0xFFFFFFFF or 1
        t.crop_width = int(info[20]) >> 32
        t.crop_height = int(info[20]) & 0xFFFFFFFF
        t.color_matrix = int(info[21]) & 0xFF
        t.color_full_range = ((int(info[21]) >> 8) & 0xFF) - 1
        t.interlaced = ((int(info[21]) >> 16) & 0xFF) - 1
        t.bitrate_max = int(info[22])
        t.bitrate_avg = int(info[23])
        # ns rescale + framerate exactly as containers/mp4.py:393-429
        scale = 1e9 / (t.timescale or 1)
        pts_ns = (pts * scale).astype(np.int64)
        dts_ns = (dts * scale).astype(np.int64)
        t.set_samples(types, sizes, offs, pts_ns, dts_ns)
        if (stream_type == StreamType.VIDEO and t.duration_units > 0
                and n > 1):
            t.framerate = n * t.timescale / t.duration_units
        t.compute_codec()
        t.compute_stats()
    elif container == Container.AVI:
        # framerate + synthesized PTS exactly as containers/avi.py:148-157
        scale_, rate_ = int(info[10]), int(info[11])
        if stream_type == StreamType.VIDEO and scale_:
            t.framerate = rate_ / scale_
        if t.framerate > 0:
            p = (np.arange(n) * (1e9 / t.framerate)).astype(np.int64)
            t.set_samples(types, sizes, offs, p, p)
        else:
            t.set_samples(types, sizes, offs)
        t.timescale = t.duration_units = 0
        t.compute_stats()
    elif container == Container.WAVE:
        # single-sample track fields exactly as containers/wave.py
        t.set_samples(types, sizes, offs, pts, dts)
        byterate8 = int(info[16])
        fact_samples = int(info[19])
        if fact_samples and t.sampling_rate:
            # sample-accurate duration from fact (wave.c:271-277)
            t.stream_duration_ms = fact_samples * 1000.0 / t.sampling_rate
        elif byterate8:
            t.stream_duration_ms = int(sizes[0]) * 1000.0 / (byterate8 // 8)
        if byterate8:
            t.bitrate = byterate8
        t.stream_size = int(sizes[0])
        t.frame_count = 1
    elif container == Container.MPEG_PS:
        # 90 kHz -> ns and fragment lists exactly as containers/mpeg_ps.py
        pts_ns = np.where(pts >= 0, pts * 100000 // 9, -1).astype(np.int64)
        dts_ns = np.where(dts >= 0, dts * 100000 // 9, -1).astype(np.int64)
        t.set_samples(types, sizes, offs, pts_ns, dts_ns)
        t.fragments = frags
        t.track_id = 0
        t.compute_stats()
    elif container == Container.ES:
        t.set_samples(types, sizes, offs)
        t.compute_stats()
    elif container == Container.MKV:
        # tick -> ns via TimestampScale, exactly as containers/mkv.py
        timescale = int(info[10]) or 1_000_000
        if n:
            t.set_samples(types, sizes, offs, pts * timescale,
                          dts * timescale)
            t.compute_stats()
        t.timescale = t.duration_units = 0
        if t.stream_codec == Codec.H264 and psets:
            t.length_prefixed = True
    elif container == Container.MPEG_TS:
        # 90 kHz -> ns + fragment lists, exactly as containers/ts.py
        pts_ns = np.where(pts >= 0, pts * 100000 // 9, -1).astype(np.int64)
        dts_ns = np.where(dts >= 0, dts * 100000 // 9, -1).astype(np.int64)
        t.set_samples(types, sizes, offs, pts_ns, dts_ns)
        t.fragments = frags
        t.compute_stats()
    elif container == Container.ES_MP3:
        # synthesized PTS exactly as containers/mp3.py:122-129
        frame_ns = int(int(info[15]) * 1e9 / (t.sampling_rate or 1))
        p = (np.arange(n) * frame_ns).astype(np.int64)
        t.set_samples(types, sizes, offs, p, p)
        t.compute_stats()
        t.bitrate_mode = (BitrateMode.CBR if int(info[17]) == 1
                          else BitrateMode.VBR)
        t.bitrate = int(info[16] / n)      # int(np.mean(bitrates))
    else:
        return None
    return t

"""AVI (RIFF) demuxer.

Reference: minivideo/src/demuxer/avi/avi.c — RIFF/LIST walk over
'RIFF AVI ' + 'AVIX' (OpenDML) (:1373-1533), hdrl/avih/strl/strh/strf
(:136-286,745-857), movi offset, legacy idx1 index (:478) and OpenDML
indx/ix super+standard indexes (parse_indx :621-743, consumed by
avi_indexer :1272-1298).  Divergences from reference bugs (not
replicated): keyframe flag indexing `[i]` vs `[k]` (avi.c:1330), and
the OpenDML delta-frame bit — the reference tests 0x10000000
(avi.c:713) where the OpenDML spec defines AVISTDINDEX_DELTAFRAME as
bit 31 (0x80000000).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..codecs import (Codec, SampleType, StreamType, WAVE_FORMAT_TO_CODEC,
                      codec_from_fourcc)
from ..media import MediaFile, Track
from .. import trace
from .riff import iter_chunks

AVIIF_KEYFRAME = 0x10


@dataclass
class _Stream:
    fcc_type: bytes = b""
    fcc_handler: bytes = b""
    scale: int = 1
    rate: int = 1
    width: int = 0
    height: int = 0
    codec: Codec = Codec.UNKNOWN
    channels: int = 0
    sample_rate: int = 0
    bits: int = 0
    samples: list = field(default_factory=list)   # (offset, size, keyframe)
    indx_raw: bytes = b""       # OpenDML 'indx' chunk content (in strl)


AVI_INDEX_OF_INDEXES = 0x00
AVI_INDEX_OF_CHUNKS = 0x01


def _parse_odml_index(fh, raw: bytes, s: _Stream, file_size: int,
                      depth: int = 0) -> None:
    """OpenDML 'indx'/'ix..' chunk content (reference parse_indx,
    avi.c:621-743).

    Header: wLongsPerEntry u16, bIndexSubType u8, bIndexType u8,
    nEntriesInUse u32, dwChunkId u32.  Super-index entries (type 0x00):
    qwOffset u64 (absolute, points at an 'ix..' chunk), dwSize u32,
    dwDuration u32.  Standard-index entries (type 0x01): base qwOffset
    u64 + per-entry dwOffset u32 (to the sample DATA) and dwSize u32
    with bit 31 = AVISTDINDEX_DELTAFRAME (not a keyframe)."""
    if len(raw) < 12 or depth > 2:
        return
    _wlpe, _sub, btype, n_use = struct.unpack("<HBBI", raw[:8])
    if btype == AVI_INDEX_OF_INDEXES:
        p = 24                                 # dwChunkId + 3x dwReserved
        for _ in range(n_use):
            if p + 16 > len(raw):
                break
            qw_off, dsize, _dur = struct.unpack("<QII", raw[p:p + 16])
            p += 16
            if not (0 < qw_off < file_size):
                trace.warning("AVI", "super-index entry offset %d out of "
                              "file bounds", qw_off)
                continue
            fh.seek(qw_off)
            hdr = fh.read(8)
            if len(hdr) < 8 or hdr[:2] != b"ix":
                trace.warning("AVI", "super-index entry at %d is not an "
                              "ix chunk", qw_off)
                continue
            csize = struct.unpack("<I", hdr[4:8])[0]
            csize = min(csize, file_size - qw_off - 8)
            _parse_odml_index(fh, fh.read(csize), s, file_size, depth + 1)
    elif btype == AVI_INDEX_OF_CHUNKS:
        if len(raw) < 24:
            return
        base, = struct.unpack("<Q", raw[12:20])
        p = 24
        for _ in range(n_use):
            if p + 8 > len(raw):
                break
            doff, dsize = struct.unpack("<II", raw[p:p + 8])
            p += 8
            s.samples.append((base + doff, dsize & 0x7FFFFFFF,
                              not (dsize & 0x80000000)))
    else:
        trace.warning("AVI", "unsupported indx bIndexType 0x%02X", btype)


def avi_parse(media: MediaFile) -> bool:
    fh = media.file_handle
    fh.seek(0)
    hdr = fh.read(12)
    if hdr[:4] != b"RIFF" or hdr[8:12] not in (b"AVI ", b"AVIX"):
        return False
    riff_size = struct.unpack("<I", hdr[4:8])[0]
    end = min(8 + riff_size, media.file_size)

    streams: list[_Stream] = []
    movi_offset = [0]
    idx1 = []

    def walk(lst_end):
        for fcc, list_type, size, off in iter_chunks(fh, lst_end):
            if fcc in (b"LIST", b"RIFF"):
                if list_type == b"movi":
                    movi_offset[0] = off
                    fh.seek(off + size)        # skip data; use the index
                else:
                    pos_after = off + size
                    fh.seek(off)
                    walk(off + size)
                    fh.seek(pos_after)
            elif fcc == b"strh":
                fh.seek(off)
                s = _Stream()
                s.fcc_type = fh.read(4)
                s.fcc_handler = fh.read(4)
                fh.seek(off + 20)
                s.scale = struct.unpack("<I", fh.read(4))[0] or 1
                s.rate = struct.unpack("<I", fh.read(4))[0] or 1
                streams.append(s)
            elif fcc == b"strf" and streams:
                fh.seek(off)
                s = streams[-1]
                if s.fcc_type == b"vids":
                    # BITMAPINFOHEADER
                    data = fh.read(min(size, 40))
                    if len(data) >= 24:
                        s.width = struct.unpack("<i", data[4:8])[0]
                        s.height = abs(struct.unpack("<i", data[8:12])[0])
                        s.codec = codec_from_fourcc(
                            data[16:20].decode("latin-1"))
                        if s.codec == Codec.UNKNOWN:
                            s.codec = codec_from_fourcc(
                                s.fcc_handler.decode("latin-1"))
                elif s.fcc_type == b"auds":
                    # WAVEFORMATEX
                    data = fh.read(min(size, 18))
                    if len(data) >= 16:
                        tag, ch, rate_, _bps, _ba, bits = struct.unpack(
                            "<HHIIHH", data[:16])
                        s.codec = WAVE_FORMAT_TO_CODEC.get(
                            tag, Codec.UNKNOWN)
                        s.channels = ch
                        s.sample_rate = rate_
                        s.bits = bits
            elif fcc == b"indx" and streams:
                fh.seek(off)
                streams[-1].indx_raw = fh.read(size)
            elif fcc == b"idx1":
                fh.seek(off)
                raw = fh.read(size)
                idx1.append(raw)

    walk(end)

    # legacy index: entries of (fourcc, flags, offset, size)
    # (reference avi_indexer :1272-1298)
    for raw in idx1:
        n = len(raw) // 16
        arr = np.frombuffer(raw[:n * 16], dtype="<u4").reshape(-1, 4)
        fccs = np.frombuffer(raw[:n * 16], dtype="S4")[::4]
        # offset convention: usually relative to the 'movi' fourcc
        # (first entry ~4); some muxers write absolute file offsets —
        # decide once from the first entry
        absolute = bool(n) and int(arr[0, 2]) >= movi_offset[0]
        base = 8 if absolute else movi_offset[0] - 4 + 8
        for k in range(n):
            fcc = fccs[k]
            if len(fcc) < 4 or not fcc[:2].isdigit():
                continue
            snum = int(fcc[:2])
            if snum >= len(streams):
                continue
            flags, offset, size = (int(arr[k, 1]), int(arr[k, 2]),
                                   int(arr[k, 3]))
            streams[snum].samples.append(
                (offset + base, size, bool(flags & AVIIF_KEYFRAME)))

    # OpenDML index: used for streams idx1 did not cover (reference
    # avi_indexer only walks the super-index of tracks not already
    # indexed, avi.c:1280-1298); this is what indexes >1 GiB AVIX files
    for s in streams:
        if s.indx_raw and not s.samples:
            _parse_odml_index(fh, s.indx_raw, s, media.file_size)

    ok = False
    for s in streams:
        if not s.samples:
            continue
        if s.fcc_type == b"vids":
            st = StreamType.VIDEO
            types = [int(SampleType.VIDEO_SYNC) if kf
                     else int(SampleType.VIDEO)
                     for _, _, kf in s.samples]
        elif s.fcc_type == b"auds":
            st = StreamType.AUDIO
            types = [int(SampleType.AUDIO)] * len(s.samples)
        else:
            continue
        t = Track(stream_type=st, stream_codec=s.codec,
                  width=s.width, height=s.height,
                  channel_count=s.channels, sampling_rate=s.sample_rate,
                  bit_per_sample=s.bits)
        t.framerate = s.rate / s.scale if st == StreamType.VIDEO else 0.0
        offs = [o for o, _, _ in s.samples]
        sizes = [sz for _, sz, _ in s.samples]
        # synthesize PTS from framerate
        if t.framerate > 0:
            pts = (np.arange(len(offs)) * (1e9 / t.framerate)).astype(
                np.int64)
        else:
            pts = None
        t.set_samples(types, sizes, offs, pts, pts)
        t.compute_stats()
        media.add_track(t)
        ok = True
        trace.info("AVI", "stream %s: %d samples, codec %s",
                   s.fcc_type, len(offs), s.codec.name)
    media.parsed = ok
    return ok

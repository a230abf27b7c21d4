"""WAVE demuxer.

Reference: minivideo/src/demuxer/wave/wave.c — fmt (incl. cbSize
extensions for MP1/MP3/EXTENSIBLE, :46-123), fact (:166-190), cue
(:196-222) and data (:228-253) chunks; builds a single-sample track
covering the whole data chunk (:254-364) with the codec derived from
wFormatTag (:266-333).  Divergences from the reference (documented,
not replicated): the reference's stream_size formula for PCM multiplies
bits-per-sample by 8 twice (wave.c:273), and its EXTENSIBLE parse reads
the WAVEFORMATEXTENSIBLE Samples union as THREE sequential WORDs
(wave.c:108-118) — per mmreg.h it is ONE word, so the reference's
dwChannelMask/SubFormat land 4 bytes late; we use the mmreg.h layout.
"""

from __future__ import annotations

import struct

from ..codecs import Codec, SampleType, StreamType, WAVE_FORMAT_TO_CODEC
from ..media import MediaFile, Track
from .. import trace
from .riff import iter_chunks

WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# KSDATAFORMAT_SUBTYPE GUIDs embed the classic wFormatTag in their first
# two (little-endian) bytes; the remaining 14 bytes are the fixed suffix
# 00-00-00-00-10-00-80-00-00-AA-00-38-9B-71 (mmreg.h).
_KS_GUID_SUFFIX = bytes.fromhex("000000001000800000AA00389B71")


def _parse_fmt(raw: bytes) -> dict:
    """fmt chunk incl. the cbSize extension block (wave.c:46-123)."""
    fmt: dict = {}
    if len(raw) < 16:
        return fmt
    (fmt["tag"], fmt["channels"], fmt["rate"],
     fmt["byterate"], fmt["align"], fmt["bits"]) = \
        struct.unpack("<HHIIHH", raw[:16])
    if len(raw) >= 18:
        (cb,) = struct.unpack("<H", raw[16:18])
        ext = raw[18:18 + cb]
        fmt["cb_size"] = cb
        if fmt["tag"] == WAVE_FORMAT_EXTENSIBLE and len(ext) >= 22:
            # mmreg.h WAVEFORMATEXTENSIBLE: Samples union (ONE word),
            # dwChannelMask, SubFormat GUID
            (fmt["valid_bits"], fmt["channel_mask"]) = \
                struct.unpack("<HI", ext[:6])
            guid = ext[6:22]
            fmt["subformat"] = guid
            if guid[2:16] == _KS_GUID_SUFFIX:
                # GUID of the standard KS family: first 2 LE bytes are
                # the embedded classic wFormatTag
                fmt["tag_effective"] = struct.unpack("<H", guid[:2])[0]
        elif fmt["tag"] in (0x0050, 0x0055) and len(ext) >= 2:
            # MPEG layer 1/2/3 extension (wave.c:80-107): only the
            # fields we surface; layout differs between MP1 and MP3
            if fmt["tag"] == 0x0055 and len(ext) >= 12:
                (fmt["mp3_id"], fmt["mp3_flags"], fmt["mp3_block_size"],
                 fmt["mp3_frames_per_block"], fmt["mp3_codec_delay"]) = \
                    struct.unpack("<HIHHH", ext[:12])
    return fmt


def _parse_cue(raw: bytes) -> list:
    """cue chunk: dwCuePoints then 24-byte cue point records (the
    reference acknowledges the chunk, wave.c:196-222; we also surface
    the points)."""
    if len(raw) < 4:
        return []
    (n,) = struct.unpack("<I", raw[:4])
    pts = []
    for i in range(min(n, (len(raw) - 4) // 24)):
        ident, pos, fcc, coff, boff, soff = struct.unpack(
            "<II4sIII", raw[4 + i * 24:4 + (i + 1) * 24])
        pts.append({"id": ident, "position": pos, "chunk": fcc,
                    "chunk_start": coff, "block_start": boff,
                    "sample_offset": soff})
    return pts


def wave_parse(media: MediaFile) -> bool:
    fh = media.file_handle
    fh.seek(0)
    hdr = fh.read(12)
    if hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
        return False
    riff_size = struct.unpack("<I", hdr[4:8])[0]
    end = min(8 + riff_size, media.file_size)

    fmt: dict = {}
    fact_samples = 0
    cues: list = []
    data_off = data_size = 0
    for fcc, _lt, size, off in iter_chunks(fh, end):
        if fcc == b"fmt ":
            fh.seek(off)
            fmt = _parse_fmt(fh.read(min(size, 64)))
        elif fcc == b"fact":
            # dwSampleLength: per-channel sample count (wave.c:166-190)
            if size >= 4:
                fh.seek(off)
                (fact_samples,) = struct.unpack("<I", fh.read(4))
        elif fcc == b"cue ":
            fh.seek(off)
            cues = _parse_cue(fh.read(min(size, 4 + 24 * 1024)))
        elif fcc == b"data":
            data_off, data_size = off, size

    if not fmt or not data_size:
        trace.error("WAVE", "missing fmt or data chunk")
        return False

    tag = fmt.get("tag_effective", fmt["tag"])
    codec = WAVE_FORMAT_TO_CODEC.get(tag, Codec.UNKNOWN)
    if fmt["tag"] == WAVE_FORMAT_EXTENSIBLE and codec == Codec.UNKNOWN:
        codec = Codec.LPCM          # reference default (wave.c:267-270)
    t = Track(stream_type=StreamType.AUDIO, stream_codec=codec,
              channel_count=fmt["channels"], sampling_rate=fmt["rate"],
              bit_per_sample=fmt.get("valid_bits") or fmt["bits"])
    # single sample covering the data chunk (reference wave.c:254-364)
    t.set_samples([int(SampleType.AUDIO)], [data_size], [data_off],
                  [0], [0])
    if fact_samples and fmt["rate"]:
        # sample-accurate duration from fact (wave.c:271-277)
        t.stream_duration_ms = fact_samples * 1000.0 / fmt["rate"]
    elif fmt["byterate"]:
        t.stream_duration_ms = data_size * 1000.0 / fmt["byterate"]
    if fmt["byterate"]:
        t.bitrate = fmt["byterate"] * 8
    t.stream_size = data_size
    t.frame_count = 1
    t.wave_fmt = fmt               # full fmt dict (analyser surfaces it)
    t.wave_cue_points = cues
    media.add_track(t)
    media.parsed = True
    trace.info("WAVE", "%s %d Hz %d ch, %d bytes PCM data",
               codec.name, fmt["rate"], fmt["channels"], data_size)
    return True

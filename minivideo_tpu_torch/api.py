"""Public API: the lifecycle facade (minivideo_tpu/api.py).

Reference: minivideo/src/minivideo.{c,h} — minivideo_open (:192),
minivideo_parse (:199), minivideo_decode (:255), minivideo_extract
(:307), minivideo_close (:343).  Opening, demuxing and extracting are
host code and import no torch; mv_decode imports the decoder when it is
called.
"""

from __future__ import annotations

import numpy as np

from .codecs import Codec, Container, PictureRepartition, SampleType
from .containers import demux
from .containers.filter import select_pictures
from .media import MediaFile, Track, open_media
from . import trace


def mv_open(path: str) -> MediaFile:
    """Open a media file and probe its container (minivideo_open)."""
    return open_media(path)


def mv_parse(media: MediaFile, audio: bool = True, video: bool = True,
             subs: bool = True) -> bool:
    """Demux the container into track sample tables (minivideo_parse)."""
    ok = demux(media)
    if not audio:
        media.tracks_audio.clear()
    if not video:
        media.tracks_video.clear()
    if not subs:
        media.tracks_subtitles.clear()
    return ok


def extract_video_stream(media: MediaFile, track: Track) -> bytes:
    """Assemble the track's H.264 stream as Annex-B bytes for decoding."""
    from .containers.mp4 import avcc_to_annexb
    fh = media.file_handle
    out = bytearray()
    for ps in track.parameter_sets:
        out += b"\x00\x00\x00\x01" + ps
    length_prefixed = (track.length_prefixed
                       or media.container == Container.MP4)
    for i in range(track.sample_count):
        if track.sample_type[i] not in (int(SampleType.VIDEO),
                                        int(SampleType.VIDEO_SYNC),
                                        int(SampleType.VIDEO_PARAM)):
            continue
        raw = track.read_sample(fh, i)
        if length_prefixed:
            out += avcc_to_annexb(raw, getattr(track, "nal_length_size", 4))
        else:
            out += b"\x00\x00\x00\x01" + raw if not raw.startswith(
                (b"\x00\x00\x01", b"\x00\x00\x00\x01")) else raw
    return bytes(out)


def mv_decode(media: MediaFile, picture_number: int = 1,
              mode: PictureRepartition = PictureRepartition.UNFILTERED,
              engine: str = "fused", device=None, want_rgb: bool = False):
    """Decode up to picture_number IDR pictures from the first video track
    (minivideo_decode).  Returns a list of DecodedPicture.  engine:
    "fused" (default), "wave" or "np" (models/h264/decoder.py).
    device=None decodes on the GPU and raises when there is none;
    device="cpu" runs the engine's torch ops on the CPU.  want_rgb: also
    convert to RGB888 on the decode's device (ops/color.py; not under
    "np", which leaves it to the host)."""
    from .device import resolve_device
    from .models.h264.decoder import decode_annexb
    device = resolve_device(device)       # no card: raises, even for []
    if not media.tracks_video:
        trace.error("MAIN", "no video track to decode")
        return []
    track = media.tracks_video[0]
    if track.stream_codec not in (Codec.H264, Codec.UNKNOWN):
        from .models.h264.params import UnsupportedStream
        raise UnsupportedStream(
            f"decoding {track.stream_codec.name} is not supported "
            f"(H.264 intra only, like the reference)")
    selected = select_pictures(media, track, picture_number, mode)
    if len(selected) == 0:
        return []
    # assemble a stream with parameter sets + selected IDR samples
    fh = media.file_handle
    out = bytearray()
    from .containers.mp4 import avcc_to_annexb
    length_prefixed = (track.length_prefixed
                       or media.container == Container.MP4)
    for ps in track.parameter_sets:
        out += b"\x00\x00\x00\x01" + ps
    for i in track.param_indices():
        raw = track.read_sample(fh, i)
        if not length_prefixed:
            out += b"\x00\x00\x00\x01" + raw if not raw.startswith(
                (b"\x00\x00\x01", b"\x00\x00\x00\x01")) else raw
    for i in selected:
        raw = track.read_sample(fh, int(i))
        if length_prefixed:
            out += avcc_to_annexb(raw, getattr(track, "nal_length_size", 4))
        else:
            out += b"\x00\x00\x00\x01" + raw if not raw.startswith(
                (b"\x00\x00\x01", b"\x00\x00\x00\x01")) else raw
    return decode_annexb(bytes(out), max_pictures=picture_number,
                         engine=engine, device=device, want_rgb=want_rgb)


def mv_extract(media: MediaFile, track: Track, out_path: str,
               output_format: str = "es") -> str:
    """Extract a track to an ES or PES file (minivideo_extract)."""
    from .muxer.muxer import export_samples
    return export_samples(media, track, out_path, output_format)


def mv_close(media: MediaFile) -> None:
    media.close()


def mv_print_infos() -> None:
    """Library/build info dump (minivideo_print_infos, minivideo.c:59)."""
    from .settings import print_infos
    print_infos()


def mv_get_infos() -> dict:
    """Version + feature flags (minivideo_get_infos, minivideo.c:140)."""
    from .settings import get_infos
    return get_infos()


def mv_endianness() -> int:
    """4321 little-endian / 1234 big-endian (minivideo_endianness,
    minivideo.c:159)."""
    from .settings import endianness
    return endianness()

"""Track extraction to ES / PES files.

Port of minivideo_tpu/muxer/muxer.py: host code, imports no torch.

Reference: minivideo/src/muxer/muxer.c — muxer_export_samples (:299),
write_es (:100-163, with Annex-B start-code injection for H.264), output
naming from codec (:224-290).
"""

from __future__ import annotations

import os

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace
from .pes_packetizer import pes_packetize

# output extension per codec (reference muxer.c:224-290)
_ES_EXT = {
    Codec.H264: "264", Codec.H265: "265",
    Codec.MPEG1: "mpgv", Codec.MPEG2: "mpgv", Codec.MPEG4_ASP: "mpgv",
    Codec.MPEG_L1: "mp1", Codec.MPEG_L2: "mp2", Codec.MPEG_L3: "mp3",
    Codec.AAC: "aac", Codec.AC3: "ac3", Codec.LPCM: "pcm",
}


def export_samples(media: MediaFile, track: Track, out_path: str,
                   output_format: str = "es") -> str:
    """Write the track's samples to an ES or PES file; returns the path."""
    if track.sample_count == 0:
        raise ValueError("track has no samples")
    if os.path.isdir(out_path):
        ext = (_ES_EXT.get(track.stream_codec, "bin")
               if output_format == "es" else "pes")
        name = f"{media.file_name}_track{track.track_id}.{ext}"
        out_path = os.path.join(out_path, name)
    h264 = track.stream_codec == Codec.H264
    # MP4 carries AVCC (length-prefixed) samples; rewrite to Annex-B with
    # the avcC parameter sets up front so the output is a valid raw stream
    from ..codecs import Container
    avcc = h264 and media.container == Container.MP4
    src = media.file_handle
    with open(out_path, "wb") as out:
        if output_format == "pes":
            pes_packetize(media, track, out)
        else:
            if h264:
                for ps in track.parameter_sets:
                    out.write(b"\x00\x00\x00\x01" + ps)
            for i in range(track.sample_count):
                stype = int(track.sample_type[i])
                if stype == int(SampleType.OTHER):
                    continue
                raw = track.read_sample(src, i)
                if avcc:
                    from ..containers.mp4 import avcc_to_annexb
                    raw = avcc_to_annexb(
                        raw, getattr(track, "nal_length_size", 4))
                elif h264 and not raw.startswith((b"\x00\x00\x01",
                                                  b"\x00\x00\x00\x01")):
                    out.write(b"\x00\x00\x00\x01")     # muxer.c:100-163
                out.write(raw)
    trace.info("MUXER", "extracted track to %s", out_path)
    return out_path

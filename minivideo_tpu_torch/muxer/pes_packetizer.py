"""PES packetizer: wrap track samples into PES packets.

Port of minivideo_tpu/muxer/pes_packetizer.py: host code, imports no
torch.

Reference: minivideo/src/muxer/pes_packetizer.c (:45-232) — fabricates
PES headers with 33-bit PTS/DTS encoding, synthetic 90 kHz PTS ticks
derived from the framerate, and Annex-B start-code injection for H.264.
"""

from __future__ import annotations

from ..codecs import Codec, SampleType, StreamType
from .. import trace


def _encode_ts(prefix: int, ts: int) -> bytes:
    """33-bit timestamp -> 5 marker-laced bytes (ISO 13818-1 2.4.3.7)."""
    return bytes([
        (prefix << 4) | (((ts >> 30) & 0x07) << 1) | 1,
        (ts >> 22) & 0xFF,
        (((ts >> 15) & 0x7F) << 1) | 1,
        (ts >> 7) & 0xFF,
        ((ts & 0x7F) << 1) | 1,
    ])


def pes_packetize(media, track, out_fh) -> int:
    """Write the track's samples as PES packets; returns bytes written."""
    src = media.file_handle
    video = track.stream_type == StreamType.VIDEO
    stream_id = 0xE0 if video else 0xC0
    h264 = track.stream_codec == Codec.H264
    from ..codecs import Container
    avcc = h264 and media.container == Container.MP4
    ps_prefix = (b"".join(b"\x00\x00\x00\x01" + ps
                          for ps in track.parameter_sets)
                 if h264 else b"")
    # synthetic 90 kHz ticks from framerate (pes_packetizer.c:96)
    tick = int(90000 / track.framerate) if track.framerate > 0 else 3600
    pts = 0
    written = 0
    for i in range(track.sample_count):
        stype = int(track.sample_type[i])
        if stype not in (int(SampleType.VIDEO), int(SampleType.VIDEO_SYNC),
                         int(SampleType.VIDEO_PARAM),
                         int(SampleType.AUDIO)):
            continue
        payload = track.read_sample(src, i)
        if avcc:
            from ..containers.mp4 import avcc_to_annexb
            payload = avcc_to_annexb(
                payload, getattr(track, "nal_length_size", 4))
        elif h264 and not payload.startswith((b"\x00\x00\x01",
                                              b"\x00\x00\x00\x01")):
            payload = b"\x00\x00\x00\x01" + payload
        if ps_prefix:
            payload = ps_prefix + payload
            ps_prefix = b""
        ts_bytes = _encode_ts(0b0010, pts)
        if stype != int(SampleType.VIDEO_PARAM):
            pts += tick
        # MPEG-2 PES header: flags + header_data_length + PTS
        header_tail = bytes([0x80, 0x80, len(ts_bytes)]) + ts_bytes
        packet_len = len(header_tail) + len(payload)
        hdr = b"\x00\x00\x01" + bytes([stream_id])
        if packet_len <= 0xFFFF:
            hdr += packet_len.to_bytes(2, "big")
        else:
            hdr += b"\x00\x00"      # unbounded (video only, legal)
        out_fh.write(hdr)
        out_fh.write(header_tail)
        out_fh.write(payload)
        written += len(hdr) + len(header_tail) + len(payload)
    trace.info("MUXER", "PES: wrote %d bytes", written)
    return written

"""PES packet parsing + elementary-stream sniffers, shared by MPEG-PS
(and later TS).

Reference: minivideo/src/demuxer/mpeg/pes/pes.c — header + extension
parsing incl. 33-bit PTS/DTS reconstruction (:107-456); ES metadata
sniffers parse_pes_a (AC-3 fscod/frmsizcod, DTS SFREQ/RATE, MPEG audio
header — :645-980) and parse_pes_v (MPEG-1/2 sequence header: size,
aspect ratio, framerate tables — :985-1120).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import trace
from ..codecs import Codec

# stream_id ranges (spec ISO 13818-1 table 2-18)
SID_PROGRAM_END = 0xB9
SID_PACK_HEADER = 0xBA
SID_SYSTEM_HEADER = 0xBB
SID_PSM = 0xBC
SID_PRIVATE_1 = 0xBD
SID_PADDING = 0xBE
SID_PRIVATE_2 = 0xBF
SID_AUDIO_FIRST = 0xC0
SID_AUDIO_LAST = 0xDF
SID_VIDEO_FIRST = 0xE0
SID_VIDEO_LAST = 0xEF
SID_PSD = 0xFF


@dataclass
class PesHeader:
    stream_id: int
    packet_length: int
    pts: int = -1           # 90 kHz ticks
    dts: int = -1
    header_size: int = 6    # bytes incl. start code
    payload_size: int = 0


def _timestamp_33(b: bytes) -> int:
    """Reassemble a 33-bit PTS/DTS from 5 marker-laced bytes
    (reference pes.c PTS/DTS parse)."""
    return (((b[0] >> 1) & 0x07) << 30) | (b[1] << 22) | \
        (((b[2] >> 1) & 0x7F) << 15) | (b[3] << 7) | ((b[4] >> 1) & 0x7F)


def parse_pes_header(data: bytes, pos: int) -> PesHeader:
    """Parse a PES packet header at `pos` (data[pos:pos+3] == 00 00 01).

    Returns a PesHeader; header_size covers everything before the ES
    payload."""
    sid = data[pos + 3]
    plen = (data[pos + 4] << 8) | data[pos + 5]
    h = PesHeader(stream_id=sid, packet_length=plen)
    p = pos + 6
    if sid in (SID_PADDING, SID_PRIVATE_2) or sid < 0xBD:
        h.header_size = p - pos
        h.payload_size = plen
        return h
    # MPEG-2 PES header
    if p + 3 > len(data):
        h.header_size = p - pos
        return h
    flags1 = data[p]
    if (flags1 >> 6) != 0b10:
        # MPEG-1 style header: skip stuffing then optional STD/PTS
        q = p
        while q < len(data) and data[q] == 0xFF:
            q += 1
        if q < len(data) and (data[q] >> 6) == 0b01:
            q += 2
        if q < len(data):
            tag = data[q] >> 4
            if tag == 0b0010:
                h.pts = _timestamp_33(data[q:q + 5])
                q += 5
            elif tag == 0b0011:
                h.pts = _timestamp_33(data[q:q + 5])
                h.dts = _timestamp_33(data[q + 5:q + 10])
                q += 10
            else:
                q += 1
        h.header_size = q - pos
        h.payload_size = plen - (q - (pos + 6))
        return h
    flags2 = data[p + 1]
    hdr_len = data[p + 2]
    q = p + 3
    pts_dts = (flags2 >> 6) & 3
    if pts_dts >= 2 and q + 5 <= len(data):
        h.pts = _timestamp_33(data[q:q + 5])
        if pts_dts == 3 and q + 10 <= len(data):
            h.dts = _timestamp_33(data[q + 5:q + 10])
        else:
            h.dts = h.pts
    h.header_size = (p + 3 + hdr_len) - pos
    h.payload_size = plen - 3 - hdr_len
    return h


# ---------------------------------------------------------------------------
# elementary-stream metadata sniffers (reference parse_pes_a / parse_pes_v)

# AC-3 (A/52 table 5.18): fscod -> sampling rate
AC3_SAMPLE_RATES = (48000, 44100, 32000)
# A/52 table 5.13: frmsizcod >> 1 -> nominal bitrate (kbps)
AC3_BITRATES = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320, 384, 448, 512, 576, 640)
# DTS core SFREQ -> sampling rate (reference pes.c:777-815)
DTS_SAMPLE_RATES = {1: 8000, 2: 16000, 3: 32000, 6: 11025, 7: 22050,
                    8: 44100, 11: 12000, 12: 24000, 13: 48000}
# DTS core RATE -> bitrate kbps (reference pes.c:816-895; 29 = "open")
DTS_BITRATES = {0: 32, 1: 56, 2: 64, 3: 96, 4: 112, 5: 128, 6: 192,
                7: 224, 8: 256, 9: 320, 10: 384, 11: 448, 12: 512,
                13: 576, 14: 640, 15: 768, 16: 960, 17: 1024, 18: 1152,
                19: 1280, 20: 1344, 21: 1408, 22: 1411, 23: 1472,
                24: 1536, 29: 2048}

# MPEG-1/2 sequence header framerate_index -> (fps, num, base)
# (reference pes.c:1059-1108)
MPEG_FRAMERATES = {1: (23.976, 24000, 1001), 2: (24.0, 24, 1),
                   3: (25.0, 25, 1), 4: (29.970, 30000, 1001),
                   5: (30.0, 30, 1), 6: (50.0, 50, 1),
                   7: (59.940, 60000, 1001), 8: (60.0, 60, 1)}

# MPEG-2 aspect_ratio_information -> display aspect ratio
# (reference pes.c:1036-1055; 1 means square pixels -> DAR from size)
MPEG2_DAR = {2: 4.0 / 3.0, 3: 16.0 / 9.0, 4: 2.21}


@dataclass
class EsAudioInfo:
    codec: Codec = Codec.UNKNOWN
    sampling_rate: int = 0
    bitrate: int = 0              # bit/s
    channels: int = 0
    extra: dict = field(default_factory=dict)


@dataclass
class EsVideoInfo:
    codec: Codec = Codec.UNKNOWN
    width: int = 0
    height: int = 0
    dar: float = 0.0
    framerate: float = 0.0
    framerate_num: int = 0
    framerate_base: int = 0


def sniff_audio_es(payload: bytes, private: bool = False) -> EsAudioInfo:
    """Identify and read the audio ES header at the start of a PES
    payload (reference parse_pes_a, pes.c:645-980).

    Handles AC-3 (raw syncframe or DVD private-stream-1 substream
    wrapper), DTS core, and MPEG-1/2 audio frames."""
    info = EsAudioInfo()
    if len(payload) < 8:
        return info
    # DVD private-stream-1 wrapper: substream id + counters (4 bytes)
    body = payload
    if private and payload[0] in range(0x80, 0xA0) \
            and payload[:2] != b"\x0b\x77":
        sync = payload.find(b"\x0b\x77", 0, 16)
        if sync >= 0:
            body = payload[sync:]
    if body[:2] == b"\x0b\x77" and len(body) >= 5:
        info.codec = Codec.AC3
        fscod = body[4] >> 6
        frmsizcod = body[4] & 0x3F
        if fscod < 3:
            info.sampling_rate = AC3_SAMPLE_RATES[fscod]
        if (frmsizcod >> 1) < len(AC3_BITRATES):
            info.bitrate = AC3_BITRATES[frmsizcod >> 1] * 1000
        return info
    if body[:4] in (b"\x7f\xfe\x80\x01", b"\x64\x58\x20\x25"):
        info.codec = Codec.DTS
        if len(body) >= 10:
            word = int.from_bytes(body[6:10], "big")
            sfreq = (word & 0x00003C00) >> 10
            rate = (word & 0x000003E0) >> 5
            info.sampling_rate = DTS_SAMPLE_RATES.get(sfreq, 0)
            info.bitrate = DTS_BITRATES.get(rate, 0) * 1000
        return info
    if body[0] == 0xFF and (body[1] & 0xE0) == 0xE0:
        from .mp3 import _parse_frame_header
        parsed = _parse_frame_header(body[0], body[1], body[2], body[3])
        layer = (body[1] >> 1) & 3
        info.codec = {3: Codec.MPEG_L1, 2: Codec.MPEG_L2,
                      1: Codec.MPEG_L3}.get(layer, Codec.MPEG_L3)
        if parsed:
            _, samplerate, bitrate, _, channels, spf = parsed
            info.sampling_rate = samplerate
            info.bitrate = bitrate
            info.channels = channels
            info.extra["sample_per_frames"] = spf
        return info
    return info


def sniff_video_es(payload: bytes) -> EsVideoInfo:
    """Identify and read the video ES header at the start of a PES
    payload (reference parse_pes_v, pes.c:985-1120).

    Handles MPEG-1/2 sequence headers (size/DAR/framerate) and H.264
    Annex-B NALUs (codec identification only — dimensions come from the
    SPS at decode time)."""
    info = EsVideoInfo()
    if len(payload) < 8:
        return info
    # the sequence header may follow a GOP/picture start code; search the
    # first bytes of the payload like the reference's startcode scan
    seq = payload.find(b"\x00\x00\x01\xb3", 0, 64)
    if seq >= 0 and len(payload) >= seq + 8:
        sizes = int.from_bytes(payload[seq + 4:seq + 8], "big")
        info.codec = Codec.MPEG2
        info.width = (sizes & 0xFFF00000) >> 20
        info.height = (sizes & 0x000FFF00) >> 8
        ari = (sizes & 0x000000F0) >> 4
        fri = sizes & 0x0000000F
        if ari == 1 and info.height:
            info.dar = info.width / info.height
        else:
            info.dar = MPEG2_DAR.get(ari, 0.0)
        if fri in MPEG_FRAMERATES:
            (info.framerate, info.framerate_num,
             info.framerate_base) = MPEG_FRAMERATES[fri]
        return info
    nal = payload.find(b"\x00\x00\x01", 0, 64)
    if nal >= 0 and nal + 3 < len(payload):
        ntype = payload[nal + 3] & 0x1F
        if ntype in (1, 5, 6, 7, 8, 9):
            info.codec = Codec.H264
    return info

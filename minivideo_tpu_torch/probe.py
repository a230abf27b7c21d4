"""Container detection: magic-byte sniffing with extension fallback.

Reference: getContainerUsingStartcodes (import.c:186-311) and
getContainerUsingExtension (import.c:323-466).
"""

from __future__ import annotations

from .codecs import Container
from . import trace


_EXTENSION_MAP = {
    # general containers (import.c:323-466)
    "avi": Container.AVI, "divx": Container.AVI,
    "webm": Container.MKV, "mkv": Container.MKV, "mka": Container.MKV,
    "mks": Container.MKV,
    "mov": Container.MP4, "mp4": Container.MP4, "m4v": Container.MP4,
    "m4a": Container.MP4, "m4p": Container.MP4, "m4b": Container.MP4,
    "mp4v": Container.MP4, "mp4a": Container.MP4, "3gp": Container.MP4,
    "3g2": Container.MP4, "3gpp": Container.MP4, "f4v": Container.MP4,
    "mpg": Container.MPEG_PS, "mpeg": Container.MPEG_PS,
    "vob": Container.MPEG_PS, "evo": Container.MPEG_PS,
    "ps": Container.MPEG_PS,
    "ts": Container.MPEG_TS, "trp": Container.MPEG_TS,
    "mts": Container.MPEG_TS, "m2ts": Container.MPEG_TS,
    "asf": Container.ASF, "wma": Container.ASF, "wmv": Container.ASF,
    "ogg": Container.OGG, "ogv": Container.OGG, "oga": Container.OGG,
    "ogx": Container.OGG, "ogm": Container.OGG, "opus": Container.OGG,
    "mxf": Container.MXF,
    "flv": Container.FLV, "f4p": Container.FLV,
    "rm": Container.RM, "rmvb": Container.RM,
    "flac": Container.FLAC,
    "wav": Container.WAVE, "wave": Container.WAVE, "amb": Container.WAVE,
    # elementary streams
    "264": Container.ES, "h264": Container.ES, "avc": Container.ES,
    "es": Container.ES, "mpv": Container.ES,
    "aac": Container.ES_AAC,
    "ac3": Container.ES_AC3,
    "mp3": Container.ES_MP3, "mp2": Container.ES_MP3, "mp1": Container.ES_MP3,
}


# the sync bytes of a BDAV stream's first three source packets, and the
# bytes detect_container reads to see them
_BDAV_SYNCS = (4, 196, 388)
HEAD_BYTES = 392


def detect_container_from_bytes(head: bytes) -> Container:
    """Sniff the container from the first bytes of the file
    (import.c:186-311)."""
    if len(head) < 4:
        return Container.UNKNOWN
    b = head

    if b[0] == 0x47:  # MPEG-TS sync byte
        return Container.MPEG_TS
    # BDAV (Blu-ray .m2ts, AVCHD .mts): 192-byte source packets, each a
    # 4-byte TP_extra_header before a TS packet
    if len(b) > _BDAV_SYNCS[-1] and all(b[i] == 0x47 for i in _BDAV_SYNCS):
        return Container.MPEG_TS
    if b[:4] == b"\x1a\x45\xdf\xa3":  # EBML
        return Container.MKV
    if b[:4] == b"RIFF" and len(b) >= 12:
        if b[8:12] == b"AVI ":
            return Container.AVI
        if b[8:12] == b"WAVE":
            return Container.WAVE
    if b[:4] == b"\x00\x00\x01\xba":  # MPEG-PS pack start
        return Container.MPEG_PS
    if b[:4] == b"\x00\x00\x01\xb3":  # MPEG-1/2 video sequence header (ES)
        return Container.ES
    # H.264 Annex-B: start code then SPS NALU
    if b[:4] == b"\x00\x00\x00\x01" and len(b) >= 5 and (b[4] & 0x1F) == 7:
        return Container.ES
    if b[:3] == b"\x00\x00\x01" and (b[3] & 0x1F) == 7:
        return Container.ES
    if len(b) >= 8 and b[4:8] == b"ftyp":  # ISO BMFF
        return Container.MP4
    if len(b) >= 8 and b[4:8] in (b"moov", b"mdat", b"wide", b"free",
                                  b"skip", b"pnot"):
        return Container.MP4  # headerless MOV variants
    if b[:4] == b"OggS":
        return Container.OGG
    if b[:4] == b"fLaC":
        return Container.FLAC
    if b[:4] == b"\x06\x0e\x2b\x34":  # SMPTE KLV key prefix
        return Container.MXF
    if b[:3] == b"FLV":
        return Container.FLV
    if b[:4] == b".RMF":
        return Container.RM
    if b[:3] == b"ID3":
        return Container.ES_MP3
    if b[0] == 0xFF and (b[1] & 0xE0) == 0xE0:  # MPEG audio syncword
        return Container.ES_MP3
    return Container.UNKNOWN


def detect_container_from_extension(ext: str) -> Container:
    return _EXTENSION_MAP.get(ext.lower().lstrip("."), Container.UNKNOWN)


def detect_container(fh, extension: str = "") -> Container:
    pos = fh.tell()
    fh.seek(0)
    head = fh.read(HEAD_BYTES)
    fh.seek(pos)
    c = detect_container_from_bytes(head)
    if c == Container.UNKNOWN and extension:
        c = detect_container_from_extension(extension)
        if c != Container.UNKNOWN:
            trace.warning("PROBE",
                          "container detected from extension only: %s", c.name)
    return c

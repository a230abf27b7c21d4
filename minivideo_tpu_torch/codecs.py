"""Container / codec / picture-format identification.

Parity with the reference's enum + string-table layer
(reference: minivideo/src/avcodecs.{c,h}, avutils.h, fourcc.{c,h}),
re-expressed as Python IntEnums with the same coverage: 16 containers plus
ES pseudo-containers (avcodecs.h:33-63), ~80 audio/video/subtitle codecs
(avcodecs.h:66-175), picture formats (avcodecs.h:180-193), and the
FourCC -> codec map (fourcc.c:70).
"""

from __future__ import annotations

from enum import IntEnum


class Container(IntEnum):
    UNKNOWN = 0
    # general purpose
    AVI = 1
    ASF = 2
    MKV = 3
    MP4 = 4
    MPEG_PS = 5
    MPEG_TS = 6
    MPEG_MT = 7
    MXF = 8
    FLV = 9
    OGG = 10
    RM = 11
    # audio
    FLAC = 12
    WAVE = 13
    # elementary-stream pseudo-containers
    ES = 16
    ES_AAC = 17
    ES_AC3 = 18
    ES_MP3 = 19


class Codec(IntEnum):
    UNKNOWN = 0
    # audio
    MPEG_L1 = 1
    MPEG_L2 = 2
    MPEG_L3 = 3
    AAC = 4
    AAC_HE = 5
    AAC_LD = 6
    MPEG4_ALS = 7
    MPEG4_CELP = 8
    MPEG4_DST = 9
    MPEG4_HVXC = 10
    MPEG4_SLS = 11
    MPEGH_3D_AUDIO = 12
    SPEEX = 32
    VORBIS = 33
    OPUS = 34
    AC3 = 35
    EAC3 = 38
    AC4 = 40
    DTS = 42
    DTS_HD = 43
    DTS_X = 44
    WMA = 49
    MPC = 50
    APE = 64
    FLAC = 65
    ALAC = 66
    LPCM = 128
    LogPCM = 129
    DPCM = 130
    ADPCM = 131
    PDM = 132
    # video
    MPEG1 = 256
    H261 = 257
    MPEG2 = 258
    MPEG4_ASP = 259
    MSMPEG4 = 260
    H263 = 261
    H264 = 262
    H265 = 263
    WMV7 = 264
    WMV8 = 265
    WMV9 = 266
    WMSCR = 267
    WMP = 268
    VP3 = 269
    VP4 = 270
    VP5 = 271
    VP6 = 272
    VP7 = 273
    VP8 = 274
    VP9 = 275
    VP10 = 276
    DAALA = 277
    VC1 = 278
    VC2 = 279
    VC3 = 280
    VC5 = 281
    PRORES_4444 = 282
    PRORES_4444_XQ = 283
    PRORES_422_HQ = 284
    PRORES_422 = 285
    PRORES_422_PROXY = 286
    PRORES_422_LT = 287
    CINEPAK = 288
    SVQ1 = 289
    SVQ3 = 290
    IV31 = 291
    IV41 = 292
    IV50 = 293
    icod = 294
    rpza = 295
    # subtitles
    SRT = 512
    SSA = 513
    ASS = 514


class PictureFormat(IntEnum):
    UNKNOWN = 0
    BMP = 1
    JPG = 2
    PNG = 3
    WEBP = 4
    TGA = 5
    YUV444 = 16
    YUV420 = 17


class StreamType(IntEnum):
    UNKNOWN = 0
    AUDIO = 1
    VIDEO = 2
    TEXT = 3
    MENU = 4
    TMCD = 5
    META = 6
    HINT = 7


class SampleType(IntEnum):
    UNKNOWN = 0
    AUDIO = 1
    AUDIO_TAG = 2
    VIDEO = 3
    VIDEO_SYNC = 4      # IDR / keyframe
    VIDEO_PARAM = 5     # SPS/PPS pseudo-sample
    TEXT = 6
    TEXT_FILE = 7
    OTHER = 8


class BitrateMode(IntEnum):
    UNKNOWN = 0
    CBR = 1
    VBR = 2
    ABR = 3
    CVBR = 4


class FramerateMode(IntEnum):
    UNKNOWN = 0
    CFR = 1
    VFR = 2


class PictureRepartition(IntEnum):
    UNFILTERED = 0
    ORDERED = 1
    DISTRIBUTED = 2


class SubSampling(IntEnum):
    UNKNOWN = 0
    SS_400 = 1
    SS_411 = 2
    SS_420 = 3
    SS_422 = 4
    SS_444 = 5
    SS_4444 = 6


class ColorMatrix(IntEnum):
    """Video color matrix (reference ColorMatrix_e, avutils.h:163-180)."""
    UNKNOWN = 0
    SRGB = 1
    SYCC = 2
    XVYCC = 3
    XYZ = 4
    PAL = 5
    NTSC = 6
    SMPTE170M = 7
    SMPTE240M = 8
    BT470 = 9
    BT601 = 10
    BT709 = 11
    BT2020 = 12


def fourcc_be(code: str) -> int:
    """'avc1' -> big-endian fourcc integer."""
    b = code.encode("latin-1")
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


def fourcc_str(fcc: int) -> str:
    """big-endian fourcc integer -> 4-char string."""
    return bytes(((fcc >> 24) & 0xFF, (fcc >> 16) & 0xFF,
                  (fcc >> 8) & 0xFF, fcc & 0xFF)).decode("latin-1", "replace")


# FourCC -> Codec map (coverage mirrors reference fourcc.c:70-...)
_FOURCC_MAP_STR = {
    # H.264 / AVC
    "avc1": Codec.H264, "AVC1": Codec.H264, "avcc": Codec.H264,
    "AVCC": Codec.H264, "h264": Codec.H264, "H264": Codec.H264,
    "x264": Codec.H264, "X264": Codec.H264, "davc": Codec.H264,
    "DAVC": Codec.H264, "vssh": Codec.H264, "VSSH": Codec.H264,
    # H.265 / HEVC
    "hvc1": Codec.H265, "HVC1": Codec.H265, "hev1": Codec.H265,
    "h265": Codec.H265, "H265": Codec.H265, "x265": Codec.H265,
    "hevc": Codec.H265, "HEVC": Codec.H265,
    # MPEG-1/2
    "mpg1": Codec.MPEG1, "MPG1": Codec.MPEG1, "mp1v": Codec.MPEG1,
    "mpeg": Codec.MPEG1, "MPEG": Codec.MPEG1,
    "mpg2": Codec.MPEG2, "MPG2": Codec.MPEG2, "mp2v": Codec.MPEG2,
    "MPG v": Codec.MPEG2,
    # MPEG-4 part 2 ASP (and popular implementations)
    "mp4v": Codec.MPEG4_ASP, "MP4V": Codec.MPEG4_ASP,
    "xvid": Codec.MPEG4_ASP, "XVID": Codec.MPEG4_ASP,
    "divx": Codec.MPEG4_ASP, "DIVX": Codec.MPEG4_ASP,
    "DX50": Codec.MPEG4_ASP, "dx50": Codec.MPEG4_ASP,
    "FMP4": Codec.MPEG4_ASP, "fmp4": Codec.MPEG4_ASP,
    "DIV1": Codec.MSMPEG4, "div1": Codec.MSMPEG4,
    "DIV2": Codec.MSMPEG4, "div2": Codec.MSMPEG4,
    "DIV3": Codec.MSMPEG4, "div3": Codec.MSMPEG4,
    "DIV4": Codec.MSMPEG4, "div4": Codec.MSMPEG4,
    "MP42": Codec.MSMPEG4, "mp42": Codec.MSMPEG4,
    "MP43": Codec.MSMPEG4, "mp43": Codec.MSMPEG4,
    # H.263
    "h263": Codec.H263, "H263": Codec.H263, "s263": Codec.H263,
    # Windows Media
    "WMV1": Codec.WMV7, "wmv1": Codec.WMV7,
    "WMV2": Codec.WMV8, "wmv2": Codec.WMV8,
    "WMV3": Codec.WMV9, "wmv3": Codec.WMV9,
    "WMVA": Codec.VC1, "wmva": Codec.VC1, "WVC1": Codec.VC1,
    # VPx
    "VP30": Codec.VP3, "VP31": Codec.VP3, "VP40": Codec.VP4,
    "VP50": Codec.VP5, "VP60": Codec.VP6, "VP61": Codec.VP6,
    "VP62": Codec.VP6, "VP6F": Codec.VP6, "VP70": Codec.VP7,
    "VP80": Codec.VP8, "VP90": Codec.VP9,
    # pro / intermediate codecs
    "CFHD": Codec.VC5, "cfhd": Codec.VC5,
    "AVdn": Codec.VC3,
    "apch": Codec.PRORES_422_HQ, "apcn": Codec.PRORES_422,
    "apcs": Codec.PRORES_422_LT, "apco": Codec.PRORES_422_PROXY,
    "ap4h": Codec.PRORES_4444, "ap4x": Codec.PRORES_4444_XQ,
    "cvid": Codec.CINEPAK,
    "SVQ1": Codec.SVQ1, "svq1": Codec.SVQ1, "SVQ3": Codec.SVQ3,
    "IV31": Codec.IV31, "IV32": Codec.IV31, "IV41": Codec.IV41,
    "IV50": Codec.IV50,
    "icod": Codec.icod, "rpza": Codec.rpza,
    # audio
    "mp4a": Codec.AAC, "MP4A": Codec.AAC, "AACL": Codec.AAC,
    "mp3 ": Codec.MPEG_L3, ".mp3": Codec.MPEG_L3,
    "ac-3": Codec.AC3, "ac-4": Codec.AC4, "ec-3": Codec.EAC3,
    "sowt": Codec.LPCM, "twos": Codec.LPCM, "lpcm": Codec.LPCM,
    "raw ": Codec.LPCM, "alaw": Codec.LogPCM, "ulaw": Codec.LogPCM,
    "alac": Codec.ALAC, "fLaC": Codec.FLAC,
    "samr": Codec.UNKNOWN,
}

FOURCC_TO_CODEC = {fourcc_be(k): v for k, v in _FOURCC_MAP_STR.items()}


def codec_from_fourcc(fcc) -> Codec:
    """Map a fourcc (int big-endian or 4-char string) to a Codec.

    Reference: getCodecFromFourCC (fourcc.c:70).
    """
    if isinstance(fcc, str):
        fcc = fourcc_be(fcc)
    return FOURCC_TO_CODEC.get(fcc, Codec.UNKNOWN)


# WAVE wFormatTag -> Codec (reference: wave.c:266-333)
WAVE_FORMAT_TO_CODEC = {
    0x0001: Codec.LPCM,       # PCM
    0x0002: Codec.ADPCM,      # MS ADPCM
    0x0003: Codec.LPCM,       # IEEE float
    0x0006: Codec.LogPCM,     # A-law
    0x0007: Codec.LogPCM,     # mu-law
    0x0050: Codec.MPEG_L1,    # MPEG-1 audio (layer 1/2)
    0x0055: Codec.MPEG_L3,    # MP3
    0x0092: Codec.AC3,        # Dolby AC-3 (SPDIF)
    0x00FF: Codec.AAC,
    0x0160: Codec.WMA, 0x0161: Codec.WMA, 0x0162: Codec.WMA,
    0x0163: Codec.WMA,
    0x2000: Codec.AC3,
    0x2001: Codec.DTS,
    0xA106: Codec.AAC,
    0xF1AC: Codec.FLAC,
}


def container_name(c: Container, long: bool = False) -> str:
    _long = {
        Container.AVI: "Audio Video Interleave",
        Container.ASF: "Advanced Systems Format",
        Container.MKV: "Matroska",
        Container.MP4: "ISO Base Media file format",
        Container.MPEG_PS: "MPEG Program Stream",
        Container.MPEG_TS: "MPEG Transport Stream",
        Container.MPEG_MT: "MPEG Media Transport",
        Container.MXF: "Material eXchange Format",
        Container.FLV: "Flash Video",
        Container.OGG: "Ogg",
        Container.RM: "RealMedia",
        Container.FLAC: "Free Lossless Audio Codec",
        Container.WAVE: "Waveform Audio",
        Container.ES: "Elementary Stream",
        Container.ES_AAC: "AAC Elementary Stream",
        Container.ES_AC3: "AC-3 Elementary Stream",
        Container.ES_MP3: "MP3 Elementary Stream",
    }
    if long and c in _long:
        return _long[c]
    return c.name


def codec_name(c: Codec, long: bool = False) -> str:
    _long = {
        Codec.MPEG_L3: "MPEG-1/2 Audio Layer III",
        Codec.AAC: "Advanced Audio Coding",
        Codec.AC3: "Dolby Digital AC-3",
        Codec.H264: "H.264 / MPEG-4 Part 10 AVC",
        Codec.H265: "H.265 / MPEG-H Part 2 HEVC",
        Codec.MPEG4_ASP: "MPEG-4 Part 2 Advanced Simple Profile",
        Codec.LPCM: "Linear PCM",
    }
    if long and c in _long:
        return _long[c]
    return c.name


def picture_name(p: PictureFormat) -> str:
    return p.name

"""Minimal container *writers* for demuxer tests and chip_smoke.py.

The port's copy of tests/fixtures/containers.py, with the port's imports:
it builds tiny-but-valid MP4 / AVI / Matroska / WAVE / MPEG-PS / MPEG-TS /
MP3 files around Annex-B streams (testing/h264enc.py, h264enc2.py).
tests/test_torch_isolation.py holds its files byte-identical to the
fixture's.
"""

from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# MP4


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int,
              payload: bytes) -> bytes:
    return _box(fourcc, bytes([version]) + flags.to_bytes(3, "big")
                + payload)


def annexb_to_avcc_samples(annexb: bytes):
    """Split an Annex-B stream into (sps_list, pps_list, samples) where
    each sample is a length-prefixed AVCC access unit (one IDR)."""
    from ..models.h264.nalu import split_annexb
    sps, pps, samples = [], [], []
    current = bytearray()
    for off, nal in split_annexb(annexb):
        ntype = nal[0] & 0x1F
        if ntype == 7:
            sps.append(nal)
        elif ntype == 8:
            pps.append(nal)
        elif ntype == 5:
            first_mb_zero = (nal[1] & 0x80) != 0   # ue(0) starts with '1'
            if first_mb_zero and current:
                samples.append(bytes(current))
                current = bytearray()
            current += len(nal).to_bytes(4, "big") + nal
        # filler and others dropped
    if current:
        samples.append(bytes(current))
    return sps, pps, samples


def write_mp4(annexb: bytes, width: int, height: int,
              timescale: int = 30000, sample_delta: int = 1001,
              visual_ext: bool = False) -> bytes:
    """Wrap an intra-only Annex-B stream in a minimal ISO BMFF file.

    With visual_ext=True the avc1 entry also carries btrt/pasp/clap/
    colr(nclx)/fiel boxes (reference mp4.c:1941-2170)."""
    sps, pps, samples = annexb_to_avcc_samples(annexb)
    assert sps and pps and samples

    mdat_payload = b"".join(samples)
    # layout: ftyp + moov + mdat; chunk offsets need moov size known first,
    # so build moov with a placeholder and patch
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512)
                + b"isomiso2avc1mp41")

    def build_moov(chunk_base):
        avcc = bytes([1, sps[0][1], sps[0][2], sps[0][3], 0xFF,
                      0xE0 | len(sps)])
        for s in sps:
            avcc += len(s).to_bytes(2, "big") + s
        avcc += bytes([len(pps)])
        for p in pps:
            avcc += len(p).to_bytes(2, "big") + p
        ext = _box(b"avcC", avcc)
        if visual_ext:
            ext += _box(b"btrt", struct.pack(">III", 8192, 900000, 750000))
            ext += _box(b"pasp", struct.pack(">II", 4, 3))
            ext += _box(b"clap", struct.pack(
                ">8I", width - 2, 1, height - 2, 1, 0, 1, 0, 1))
            # nclx: bt709 primaries/transfer/matrix, full_range set
            ext += _box(b"colr", b"nclx"
                        + struct.pack(">HHHB", 1, 1, 1, 0x80))
            ext += _box(b"fiel", bytes([1, 0]))
        avc1 = _box(b"avc1", b"\x00" * 6 + struct.pack(">H", 1)
                    + b"\x00" * 16
                    + struct.pack(">HH", width, height)
                    + struct.pack(">II", 0x480000, 0x480000)
                    + b"\x00" * 4 + struct.pack(">H", 1)
                    + b"\x00" * 32
                    + struct.pack(">Hh", 24, -1)
                    + ext)
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + avc1)
        n = len(samples)
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n,
                                                    sample_delta))
        stss = _full_box(b"stss", 0, 0, struct.pack(">I", n) + b"".join(
            struct.pack(">I", i + 1) for i in range(n)))
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(
            struct.pack(">I", len(s)) for s in samples))
        offs = []
        pos = chunk_base
        for s in samples:
            offs.append(pos)
            pos += len(s)
        stco = _full_box(b"stco", 0, 0, struct.pack(">I", n) + b"".join(
            struct.pack(">I", o) for o in offs))
        stbl = _box(b"stbl", stsd + stts + stss + stsc + stsz + stco)
        url = _full_box(b"url ", 0, 1, b"")
        dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
        dinf = _box(b"dinf", dref)
        vmhd = _full_box(b"vmhd", 0, 1, b"\x00" * 8)
        minf = _box(b"minf", vmhd + dinf + stbl)
        hdlr = _full_box(b"hdlr", 0, 0, b"\x00" * 4 + b"vide"
                         + b"\x00" * 12 + b"tvid\x00")
        duration = n * sample_delta
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full_box(b"tkhd", 0, 7, struct.pack(">III", 0, 0, 1)
                         + b"\x00" * 4 + struct.pack(">I", duration)
                         + b"\x00" * 16
                         + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000,
                                       0, 0, 0, 0x40000000)
                         + struct.pack(">II", width << 16, height << 16))
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
            ">IIII", 0, 0, timescale, duration)
            + struct.pack(">IH", 0x10000, 0x0100) + b"\x00" * 10
            + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                          0x40000000)
            + b"\x00" * 24 + struct.pack(">I", 2))
        return _box(b"moov", mvhd + trak)

    moov0 = build_moov(0)
    chunk_base = len(ftyp) + len(moov0) + 8
    moov = build_moov(chunk_base)
    assert len(moov) == len(moov0)
    mdat = _box(b"mdat", mdat_payload)
    return ftyp + moov + mdat


# ---------------------------------------------------------------------------
# AVI


def write_avi(annexb: bytes, width: int, height: int, fps: int = 25,
              opendml: bool = False) -> bytes:
    """Wrap H.264 access units in a minimal AVI.

    idx1-indexed by default; with opendml=True the file instead carries
    an OpenDML super-index ('indx' in strl, type 0x00) whose single
    entry points at a standard 'ix00' index chunk inside movi (type
    0x01, absolute base + per-entry data offsets) and has NO idx1 —
    the layout of >1 GiB AVIX files."""
    sps, pps, samples = annexb_to_avcc_samples(annexb)
    # AVI carries Annex-B payloads; keep start codes per sample
    frames = []
    for i, s in enumerate(samples):
        # convert back to annexb payload
        from ..containers.mp4 import avcc_to_annexb
        payload = avcc_to_annexb(s)
        if i == 0:
            prefix = b"".join(b"\x00\x00\x00\x01" + x for x in sps + pps)
            payload = prefix + payload
        frames.append(payload)

    def chunk(fcc, data):
        pad = b"\x00" if len(data) & 1 else b""
        return fcc + struct.pack("<I", len(data)) + data + pad

    strh = chunk(b"strh", b"vids" + b"H264" + struct.pack(
        "<IHHIIIIIIIII", 0, 0, 0, 0, 1, fps, 0, len(frames), 0, 0, 0, 0)
        + struct.pack("<4H", 0, 0, width, height))
    bmih = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24,
                       b"H264", width * height * 3, 0, 0, 0, 0)
    strf = chunk(b"strf", bmih)

    def build(ix_abs_offset):
        parts = [strh, strf]
        if opendml:
            # super index: 1 entry -> absolute offset of the ix00 chunk
            indx = struct.pack("<HBBI4s", 4, 0, 0x00, 1, b"00dc") \
                + b"\x00" * 12 \
                + struct.pack("<QII", ix_abs_offset, 0, len(frames))
            parts.append(chunk(b"indx", indx))
        strl = chunk(b"LIST", b"strl" + b"".join(parts))
        avih = chunk(b"avih", struct.pack(
            "<IIIIIIIIIIIIII", 1000000 // fps, 0, 0, 0x10, len(frames),
            0, 1, 0, width, height, 0, 0, 0, 0))
        return chunk(b"LIST", b"hdrl" + avih + strl)

    movi_items = []
    rel_offsets = []
    pos = 4        # after 'movi'
    for f in frames:
        rel_offsets.append(pos)
        item = chunk(b"00dc", f)
        movi_items.append(item)
        pos += len(item)

    hdrl = build(0)
    movi_pos = 12 + len(hdrl)              # RIFF hdr + hdrl
    if opendml:
        # standard index chunk placed inside movi, after the frames
        base = movi_pos                    # qwBaseOffset
        entries = b"".join(
            struct.pack("<II", 8 + rel + 8, len(f))   # -> frame DATA
            for rel, f in zip(rel_offsets, frames))
        ixbody = struct.pack("<HBBI4s", 2, 0, 0x01, len(frames), b"00dc") \
            + struct.pack("<QI", base, 0) + entries
        ix_item = chunk(b"ix00", ixbody)
        ix_abs = movi_pos + 8 + pos        # movi hdr + items so far
        movi = chunk(b"LIST", b"movi" + b"".join(movi_items) + ix_item)
        hdrl = build(ix_abs)
        riff_payload = b"AVI " + hdrl + movi
    else:
        movi = chunk(b"LIST", b"movi" + b"".join(movi_items))
        idx = b"".join(
            b"00dc" + struct.pack("<III", 0x10, off, len(f))
            for off, f in zip(rel_offsets, frames))
        riff_payload = b"AVI " + hdrl + movi + chunk(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload


# ---------------------------------------------------------------------------
# Matroska


def _ebml_el(eid: int, payload: bytes) -> bytes:
    idb = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    n = len(payload)
    for ln in range(1, 9):
        if n < (1 << (7 * ln)) - 1:
            size = ((1 << (7 * ln)) | n).to_bytes(ln, "big")
            break
    return idb + size + payload


def _ebml_uint(eid: int, v: int) -> bytes:
    b = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    return _ebml_el(eid, b)


def write_mkv(annexb: bytes, width: int, height: int,
              lacing: str = "none", info_last: bool = False,
              timescale: int = 1000000) -> bytes:
    """Wrap H.264 access units in a minimal Matroska file (SimpleBlocks
    across two Clusters; AVCC length-prefixed frames + avcC
    CodecPrivate).  lacing: "none" or "xiph" (all frames in one laced
    SimpleBlock, still keyframes).  info_last=True emits the Info
    element (TimestampScale) AFTER Tracks+Clusters — legal EBML
    ordering that forces parsers to apply the timescale post-walk."""
    sps, pps, samples = annexb_to_avcc_samples(annexb)
    avcc = bytes([1, sps[0][1], sps[0][2], sps[0][3], 0xFF,
                  0xE0 | len(sps)])
    for s in sps:
        avcc += len(s).to_bytes(2, "big") + s
    avcc += bytes([len(pps)])
    for p in pps:
        avcc += len(p).to_bytes(2, "big") + p

    ebml = _ebml_el(0x1A45DFA3,
                    _ebml_uint(0x4286, 1)            # EBMLVersion
                    + _ebml_uint(0x42F7, 1)          # EBMLReadVersion
                    + _ebml_uint(0x42F2, 4) + _ebml_uint(0x42F3, 8)
                    + _ebml_el(0x4282, b"matroska")  # DocType
                    + _ebml_uint(0x4287, 4) + _ebml_uint(0x4285, 2))
    info = _ebml_el(0x1549A966, _ebml_uint(0x2AD7B1, timescale))
    video = _ebml_el(0xE0, _ebml_uint(0xB0, width) + _ebml_uint(0xBA,
                                                                height))
    entry = _ebml_el(0xAE, _ebml_uint(0xD7, 1) + _ebml_uint(0x73C5, 1)
                     + _ebml_uint(0x83, 1)
                     + _ebml_el(0x86, b"V_MPEG4/ISO/AVC")
                     + _ebml_el(0x63A2, avcc) + video)
    tracks = _ebml_el(0x1654AE6B, entry)

    def simpleblock(frames, rel_ts):
        hdr = bytes([0x81]) + rel_ts.to_bytes(2, "big", signed=True)
        if len(frames) == 1:
            return _ebml_el(0xA3, hdr + bytes([0x80]) + frames[0])
        # Xiph lacing, keyframe flag set
        flags = 0x80 | 0x02
        table = bytes([len(frames) - 1])
        for f in frames[:-1]:
            n = len(f)
            table += bytes([255] * (n // 255) + [n % 255])
        return _ebml_el(0xA3, hdr + bytes([flags]) + table
                        + b"".join(frames))

    clusters = b""
    if lacing == "xiph":
        body = _ebml_uint(0xE7, 0) + simpleblock(samples, 0)
        clusters += _ebml_el(0x1F43B675, body)
    else:
        half = (len(samples) + 1) // 2
        for ci, chunk in enumerate((samples[:half], samples[half:])):
            if not chunk:
                continue
            body = _ebml_uint(0xE7, ci * 1000)
            for i, f in enumerate(chunk):
                body += simpleblock([f], i * 40)
            clusters += _ebml_el(0x1F43B675, body)

    if info_last:
        segment = _ebml_el(0x18538067, tracks + clusters + info)
    else:
        segment = _ebml_el(0x18538067, info + tracks + clusters)
    return ebml + segment


def write_wav(pcm: np.ndarray, rate: int = 16000) -> bytes:
    data = pcm.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    payload = (b"WAVE"
               + b"fmt " + struct.pack("<I", len(fmt)) + fmt
               + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(payload)) + payload


def write_wav_extensible(pcm: np.ndarray, rate: int = 16000,
                         channels: int = 2, valid_bits: int = 16,
                         channel_mask: int = 0x3,
                         cue_samples=(0, 4000)) -> bytes:
    """WAVE_FORMAT_EXTENSIBLE (0xFFFE) file with fact + cue chunks:
    SubFormat = KSDATAFORMAT_SUBTYPE_PCM (embedded tag 0x0001);
    spec-conformant mmreg.h layout (Samples union = ONE word,
    cbSize = 22)."""
    data = pcm.astype("<i2").tobytes()
    guid = struct.pack("<H", 1) + bytes.fromhex(
        "000000001000800000AA00389B71")
    ext = struct.pack("<HI", valid_bits, channel_mask) + guid
    fmt = struct.pack("<HHIIHH", 0xFFFE, channels, rate,
                      rate * 2 * channels, 2 * channels, 16) \
        + struct.pack("<H", len(ext)) + ext
    n_frames = len(pcm) // channels
    fact = struct.pack("<I", n_frames)
    cue = struct.pack("<I", len(cue_samples))
    for i, s in enumerate(cue_samples):
        cue += struct.pack("<II4sIII", i + 1, s, b"data", 0, 0, s)
    payload = (b"WAVE"
               + b"fmt " + struct.pack("<I", len(fmt)) + fmt
               + b"fact" + struct.pack("<I", len(fact)) + fact
               + b"cue " + struct.pack("<I", len(cue)) + cue
               + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(payload)) + payload


# ---------------------------------------------------------------------------
# MPEG-PS


def write_ps(annexb: bytes, packet_size: int | None = None) -> bytes:
    """Wrap H.264 access units in a minimal MPEG-2 program stream.

    packet_size=None: one PES packet per access unit.  An access unit
    longer than a PES packet holds (PES_packet_length is 16 bits; a 1080p
    picture) continues in further packets without a PTS, as a muxer
    splits it.  (The fixture writer tests/fixtures/containers.py has no
    such split; both give the same bytes where every access unit fits
    one packet.)

    packet_size=k: every PES packet is k bytes long, its header included
    (the last may be shorter), and the packets ignore access unit
    boundaries, as libavformat's DVD muxers pack 2,048-byte packs: a
    packet may end inside a start code, or hold the tail of one access
    unit and the head of the next.  A packet carries a PTS only where an
    access unit starts in it, that of the first such unit."""
    sps, pps, samples = annexb_to_avcc_samples(annexb)
    from ..containers.mp4 import avcc_to_annexb
    units = [avcc_to_annexb(s) for s in samples]
    if units:
        units[0] = b"".join(b"\x00\x00\x00\x01" + x
                            for x in sps + pps) + units[0]
    out = bytearray()
    # pack header (MPEG-2): 00 00 01 BA + 10 bytes
    scr = bytes([0x44, 0x00, 0x04, 0x00, 0x04, 0x01])  # minimal SCR
    out += b"\x00\x00\x01\xba" + scr + bytes([0x01, 0x89, 0xc3]) \
        + bytes([0xf8])
    if packet_size is None:
        for i, payload in enumerate(units):
            pts = i * 3600
            while True:
                chunk = payload[:0xFFFF - (8 if pts is not None else 3)]
                payload = payload[len(chunk):]
                out += pes_packet(chunk, pts)
                if not payload:
                    break
                pts = None              # no PTS in a continuation
    else:
        es = b"".join(units)
        starts, pos = [], 0          # (stream position, PTS) per unit
        for i, u in enumerate(units):
            starts.append((pos, i * 3600))
            pos += len(u)
        room = packet_size - 14      # a 14-byte header on every packet
        for pos in range(0, len(es), room):
            pts = next((t for p, t in starts if pos <= p < pos + room),
                       None)
            # without a PTS, 5 stuffing bytes keep the header's length
            out += pes_packet(es[pos:pos + room], pts,
                              stuffing=5 if pts is None else 0)
    out += b"\x00\x00\x01\xb9"
    return bytes(out)


def pes_packet(payload: bytes, pts: int | None = None,
               stuffing: int = 0) -> bytes:
    """One MPEG-2 PES packet of video stream 0xE0 around `payload`: a PTS
    (90 kHz ticks) unless pts is None, then `stuffing` 0xFF bytes in its
    header."""
    data = (_encode_pts(pts) if pts is not None else b"") \
        + b"\xff" * stuffing
    tail = bytes([0x80, 0x80 if pts is not None else 0x00, len(data)]) \
        + data
    ln = len(tail) + len(payload)
    return b"\x00\x00\x01\xe0" + ln.to_bytes(2, "big") + tail + payload


def _encode_pts(ts):
    return bytes([
        (0b0010 << 4) | (((ts >> 30) & 7) << 1) | 1,
        (ts >> 22) & 0xFF,
        (((ts >> 15) & 0x7F) << 1) | 1,
        (ts >> 7) & 0xFF,
        ((ts & 0x7F) << 1) | 1])


def write_ps_mpeg2(width=720, height=576, ari=2, fri=3,
                   audio="mp2", n_packets=4) -> bytes:
    """Minimal MPEG-2 PS with an MPEG-2 video ES (real sequence header:
    size, aspect_ratio_information `ari`, frame_rate_code `fri`) and one
    audio ES ("mp2" MPEG-1 Layer II 48kHz stereo, or "ac3" 44.1kHz
    192kbps, or "dts" 48kHz 768kbps).  Payloads past the headers are
    filler — enough for the PES ES sniffers, not for decoding."""
    out = bytearray()
    scr = bytes([0x44, 0x00, 0x04, 0x00, 0x04, 0x01])
    out += b"\x00\x00\x01\xba" + scr + bytes([0x01, 0x89, 0xc3, 0xf8])
    seqh = b"\x00\x00\x01\xb3" + bytes([
        (width >> 4) & 0xFF,
        ((width & 0xF) << 4) | ((height >> 8) & 0xF),
        height & 0xFF,
        (ari << 4) | fri]) + bytes([0xFF, 0xFF, 0xE0, 0x20])
    pts = 3600
    for i in range(n_packets):
        payload = (seqh if i == 0 else b"") + b"\x00\x00\x01\x00" \
            + bytes(32)
        tail = bytes([0x80, 0x80, 5]) + _encode_pts(pts + i * 3600)
        ln = len(tail) + len(payload)
        out += b"\x00\x00\x01\xe0" + ln.to_bytes(2, "big") + tail + payload
    if audio == "ac3":
        # AC-3 syncframe: 0B 77 crc1(2) [fscod=1|frmsizcod=20 -> 44.1kHz
        # 192kbps] ... (A/52 5.3)
        frame = b"\x0b\x77\x00\x00" + bytes([(1 << 6) | 20]) + bytes(27)
        sid = b"\xbd"
        sub = b"\x80\x01\x00\x01"    # DVD substream wrapper
        payload = sub + frame * 3
    elif audio == "dts":
        frame = b"\x7f\xfe\x80\x01\x00\x00" + \
            ((13 << 10) | (15 << 5)).to_bytes(4, "big") + bytes(24)
        sid = b"\xbd"
        payload = frame * 3
    else:
        # MPEG-1 Layer II, 48 kHz, 192 kbps, stereo: FF FD 94 04
        frame = bytes([0xFF, 0xFD, 0x94, 0x04]) + bytes(60)
        sid = b"\xc0"
        payload = frame * 3
    tail = bytes([0x80, 0x80, 5]) + _encode_pts(3600)
    ln = len(tail) + len(payload)
    out += b"\x00\x00\x01" + sid + ln.to_bytes(2, "big") + tail + payload
    out += b"\x00\x00\x01\xb9"
    return bytes(out)


# ---------------------------------------------------------------------------
# MPEG-TS


def write_ts(annexb: bytes) -> bytes:
    """Wrap H.264 access units in a minimal single-program transport
    stream: PAT (PID 0) -> PMT (PID 0x100) -> video PES on PID 0x101,
    one PES unit per access unit, adaptation-field stuffing."""
    sps, pps, samples = annexb_to_avcc_samples(annexb)
    from ..containers.mp4 import avcc_to_annexb
    units = []
    for i, s in enumerate(samples):
        payload = avcc_to_annexb(s)
        if i == 0:
            payload = b"".join(b"\x00\x00\x00\x01" + x
                               for x in sps + pps) + payload
        units.append(payload)

    out = bytearray()
    cc = {}

    def packet(pid, payload, pusi):
        c = cc.get(pid, 0)
        cc[pid] = (c + 1) & 0xF
        hdr3 = bytes([0x47, (0x40 if pusi else 0) | (pid >> 8),
                      pid & 0xFF])
        if len(payload) == 184:
            return hdr3 + bytes([0x10 | c]) + payload
        af_len = 184 - len(payload) - 1
        af = bytes([af_len])
        if af_len > 0:
            af += bytes([0x00]) + b"\xff" * (af_len - 1)
        return hdr3 + bytes([0x30 | c]) + af + payload

    # PAT: program 1 -> PMT PID 0x100
    pat = bytes([0x00,                       # pointer_field
                 0x00, 0xB0, 13,             # table_id, section_length
                 0x00, 0x01, 0xC1, 0x00, 0x00,
                 0x00, 0x01, 0xE1, 0x00,     # prog 1 -> PID 0x100
                 0, 0, 0, 0])                # CRC (unchecked)
    out += packet(0x0000, pat, True)
    # PMT: one H.264 stream on PID 0x101
    pmt = bytes([0x00,
                 0x02, 0xB0, 18,
                 0x00, 0x01, 0xC1, 0x00, 0x00,
                 0xE1, 0x01,                 # PCR PID
                 0xF0, 0x00,                 # program_info_length
                 0x1B, 0xE1, 0x01, 0xF0, 0x00,
                 0, 0, 0, 0])
    out += packet(0x0100, pmt, True)

    for i, es in enumerate(units):
        pes = (b"\x00\x00\x01\xe0" + b"\x00\x00"      # length 0 (video)
               + bytes([0x80, 0x80, 5]) + _encode_pts(3600 * (i + 1))
               + es)
        first = True
        for off in range(0, len(pes), 184):
            out += packet(0x0101, pes[off:off + 184], first)
            first = False
    return bytes(out)


# ---------------------------------------------------------------------------
# BDAV MPEG-2 transport stream (Blu-ray .m2ts, AVCHD .mts)

BDAV_VIDEO_PID = 0x1011        # BD-ROM's primary video PID
BDAV_FPS = (24000, 1001)       # 23.976 pictures/s
BDAV_PMT_PID = 0x0100
NULL_PACKET = b"\x47\x1f\xff\x10" + b"\xff" * 184
ALIGNED_UNIT = 32              # source packets of a BDAV aligned unit


def access_units(annexb: bytes) -> list:
    """The Annex-B stream's NAL units grouped into access units, each an
    Annex-B byte string: a picture starts at a slice with
    first_mb_in_slice 0 and takes the NAL units before it (parameter
    sets, SEI); what trails the last slice stays with the last unit."""
    from ..models.h264.nalu import split_annexb
    units, pending = [], []
    for _, nal in split_annexb(annexb):
        t = nal[0] & 0x1F
        if 1 <= t <= 5 and (nal[1] & 0x80 or not units):
            units.append(pending + [nal])
            pending = []
        elif 1 <= t <= 5:
            units[-1].append(nal)
        else:
            pending.append(nal)
    if units:
        units[-1].extend(pending)
    return [b"".join(b"\x00\x00\x00\x01" + n for n in u) for u in units]


def mpeg_crc32(data: bytes) -> int:
    """CRC-32/MPEG-2 of a PSI section (ISO 13818-1 annex A)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _section(table_id: int, ext: int, body: bytes) -> bytes:
    """A PSI section with its pointer_field, header and CRC."""
    head = bytes([table_id, 0xB0 | (len(body) + 9) >> 8,
                  (len(body) + 9) & 0xFF, ext >> 8, ext & 0xFF, 0xC1, 0, 0])
    sec = head + body
    return b"\x00" + sec + mpeg_crc32(sec).to_bytes(4, "big")


def _ts_packet(pid: int, cc: int, payload: bytes, pusi: bool,
               pcr: int | None = None) -> bytes:
    """One 188-byte TS packet: `payload` (at most 184 bytes, 176 with a
    PCR), the adaptation field stuffing the rest and carrying the PCR
    (27 MHz) where given."""
    head = bytes([0x47, (0x40 if pusi else 0) | pid >> 8, pid & 0xFF])
    if pcr is None and len(payload) == 184:
        return head + bytes([0x10 | cc]) + payload
    af_len = 183 - len(payload)
    af = bytes([af_len])
    if af_len:
        opt = b""
        if pcr is not None:
            base, ext = pcr // 300, pcr % 300
            opt = ((base & 0x1FFFFFFFF) << 15 | 0x7E << 9 | ext).to_bytes(
                6, "big")
        af += bytes([0x50 if pcr is not None else 0]) + opt \
            + b"\xff" * (af_len - 1 - len(opt))
    return head + bytes([0x30 | cc]) + af + payload


def write_m2ts(annexb: bytes, ats_start: int = 0x2A0000,
               mux_rate: int | None = None, null_every: int = 0) -> bytes:
    """A BDAV MPEG-2 transport stream of the Annex-B stream's access units
    (Blu-ray Disc Read-Only Format, Part 3): 192-byte source packets, each
    a 4-byte TP_extra_header (copy_permission_indicator 0, a 30-bit
    arrival time stamp at 27 MHz) before a TS packet.  PAT and PMT
    (program 1 on PID 0x0100, an HDMV registration descriptor, PCR on
    the video PID) go before every access unit, each unit one video PES
    on PID 0x1011 (stream_type 0x1B) with its PTS at 23.976 pictures/s,
    the PCR in the adaptation field of its first packet; a null packet
    follows every `null_every` packets where that is not 0, and null
    packets pad the file to whole aligned units of 32 source packets.
    Arrival time stamps rise by one step a packet from `ats_start`: 192
    bytes at `mux_rate` bits/s, or (None) the stream's own rate, its
    packets spread over its duration."""
    aus = access_units(annexb)
    cc: dict = {}
    packets = []                     # (pid, cc, payload, pusi, pcr) or None

    def put(pid, payload, pusi, pcr=False):
        c = cc.get(pid, 0)
        cc[pid] = (c + 1) & 0xF
        packets.append((pid, c, payload, pusi, pcr))
        if null_every and len(packets) % (null_every + 1) == null_every:
            packets.append(None)

    pat = _section(0x00, 0x0001, bytes([0x00, 0x01, 0xE0 | BDAV_PMT_PID >> 8,
                                        BDAV_PMT_PID & 0xFF]))
    pmt = _section(0x02, 0x0001, bytes(
        [0xE0 | BDAV_VIDEO_PID >> 8, BDAV_VIDEO_PID & 0xFF, 0xF0, 6])
        + b"\x05\x04HDMV" + bytes(
        [0x1B, 0xE0 | BDAV_VIDEO_PID >> 8, BDAV_VIDEO_PID & 0xFF, 0xF0, 0]))
    for k, au in enumerate(aus):
        put(0x0000, pat + b"\xff" * (184 - len(pat)), True)
        put(BDAV_PMT_PID, pmt + b"\xff" * (184 - len(pmt)), True)
        pts = 90000 + k * 90000 * BDAV_FPS[1] // BDAV_FPS[0]
        pes = b"\x00\x00\x01\xe0\x00\x00\x80\x80\x05" + _encode_pts(pts) \
            + au
        put(BDAV_VIDEO_PID, pes[:176], True, True)
        for off in range(176, len(pes), 184):
            put(BDAV_VIDEO_PID, pes[off:off + 184], False)
    packets += [None] * (-len(packets) % ALIGNED_UNIT)
    n = len(packets)
    step = (192 * 8 * 27_000_000 // mux_rate if mux_rate
            else len(aus) * 27_000_000 * BDAV_FPS[1] // BDAV_FPS[0] // n)
    out = bytearray()
    for i, p in enumerate(packets):
        ats = ats_start + i * step
        out += (ats & 0x3FFFFFFF).to_bytes(4, "big")
        out += NULL_PACKET if p is None else _ts_packet(
            *p[:4], pcr=ats if p[4] else None)
    return bytes(out)


# ---------------------------------------------------------------------------
# MP3 (layer III CBR, silent frames)


def write_mp3(n_frames: int = 32, bitrate_idx: int = 9,
              samplerate_idx: int = 0) -> bytes:
    """Valid MPEG-1 Layer III CBR stream of empty frames + ID3v2 tag."""
    bitrate = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
               256, 320)[bitrate_idx] * 1000
    samplerate = (44100, 48000, 32000)[samplerate_idx]
    out = bytearray()
    # small ID3v2 tag
    tag_payload = b"\x00" * 20
    out += b"ID3\x03\x00\x00" + bytes(
        [(len(tag_payload) >> 21) & 0x7F, (len(tag_payload) >> 14) & 0x7F,
         (len(tag_payload) >> 7) & 0x7F, len(tag_payload) & 0x7F])
    out += tag_payload
    size = 1152 * bitrate // (8 * samplerate)
    hdr = bytes([0xFF, 0xFB, (bitrate_idx << 4) | (samplerate_idx << 2),
                 0x00])
    for _ in range(n_frames):
        out += hdr + b"\x00" * (size - 4)
    return bytes(out)

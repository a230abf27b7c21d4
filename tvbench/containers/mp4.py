"""The MP4 writer of the benchmark's input files: a frozen copy of
`write_mp4` (with `annexb_to_avcc_samples`) of
minivideo_tpu_torch/testing/containers.py as it stood when the benchmark
was written, without its optional visual boxes, which no mix uses.  It is
a copy so that a change to the program's writers does not move the
inputs; `pins.json` holds this file's SHA-256.
"""

from __future__ import annotations

import struct

from . import split_annexb


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int,
              payload: bytes) -> bytes:
    return _box(fourcc, bytes([version]) + flags.to_bytes(3, "big")
                + payload)


def annexb_to_avcc_samples(annexb: bytes):
    """Split an Annex-B stream into (sps_list, pps_list, samples) where
    each sample is a length-prefixed AVCC access unit (one IDR)."""
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


def write(annexb: bytes, width: int, height: int,
          timescale: int = 30000, sample_delta: int = 1001) -> bytes:
    """Wrap an intra-only Annex-B stream in a minimal ISO BMFF file."""
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

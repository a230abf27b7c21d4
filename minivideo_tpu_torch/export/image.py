"""Picture export: YUV420/YUV444 planar, BMP, TGA, PNG, JPEG.

Port of minivideo_tpu/export/image.py.  Reference: minivideo/src/export.c
(yuv :65-339, bmp/tga via stb_image_write :553-615, png :447, jpg :341)
and export_utils.c (mb_to_ycbcr :117, mb_to_rgb with BT.601
studio-swing matrix :209-326).

Production writers live in the native library (native/src/export.cc,
built at first use as `mvt_export`); every format keeps a
self-contained pure-Python writer (`*_py`) that doubles as the parity
oracle in the tests.  Where the port differs from the JAX module:
`MINIVIDEO_TPU_NO_NATIVE=1`, read at each call as the port's demuxer
and decoder read it, selects the Python writers; otherwise the native
library is built if needed, and a failed build raises instead of
falling back to Python without a word.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..codecs import PictureFormat
from .. import trace
from ..profiling import span


def _native():
    """The native export backend, or None under MINIVIDEO_TPU_NO_NATIVE=1.
    Builds the library at first use; a failed build raises."""
    if os.environ.get("MINIVIDEO_TPU_NO_NATIVE") == "1":
        return None
    from .. import native
    native.load_export()
    return native


# ---------------------------------------------------------------------------
# color conversion (reference export_utils.c:209-326, integer BT.601
# studio swing: coefficients 298/409/100/208/516 >> 8)

def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                  ) -> np.ndarray:
    """Planar YCbCr 4:2:0 -> interleaved RGB888 (native C fast path;
    bit-exact with yuv420_to_rgb_py by test)."""
    nat = _native()
    if nat is not None:
        return nat.yuv420_to_rgb_native(np.ascontiguousarray(y),
                                        np.ascontiguousarray(cb),
                                        np.ascontiguousarray(cr))
    return yuv420_to_rgb_py(y, cb, cr)


def yuv420_to_rgb_py(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                     ) -> np.ndarray:
    """Planar YCbCr 4:2:0 -> interleaved RGB888, integer BT.601
    (bit-compatible with the reference's mb_to_rgb)."""
    h, w = y.shape
    cb_up = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
    cr_up = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
    c = y.astype(np.int32) - 16
    d = cb_up.astype(np.int32) - 128
    e = cr_up.astype(np.int32) - 128
    r = (298 * c + 409 * e + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    b = (298 * c + 516 * d + 128) >> 8
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def yuv420_to_yuv444(y, cb, cr):
    h, w = y.shape
    cb_up = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
    cr_up = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
    return y, cb_up, cr_up


# ---------------------------------------------------------------------------
# writers

def write_yuv420(path, y, cb, cr) -> None:
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(y).tobytes())
        f.write(np.ascontiguousarray(cb).tobytes())
        f.write(np.ascontiguousarray(cr).tobytes())


def write_yuv444(path, y, cb, cr) -> None:
    yy, cbu, cru = yuv420_to_yuv444(y, cb, cr)
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(yy).tobytes())
        f.write(np.ascontiguousarray(cbu).tobytes())
        f.write(np.ascontiguousarray(cru).tobytes())


def write_bmp(path, rgb: np.ndarray) -> None:
    """Uncompressed 24-bit BMP (native fast path)."""
    nat = _native()
    if nat is not None:
        with open(path, "wb") as f:
            f.write(nat.encode_bmp_native(rgb))
        return
    write_bmp_py(path, rgb)


def write_bmp_py(path, rgb: np.ndarray) -> None:
    """Uncompressed 24-bit BMP (bottom-up, BGR, row-padded)."""
    h, w, _ = rgb.shape
    row = w * 3
    pad = (4 - row % 4) % 4
    img_size = (row + pad) * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 14 + 40 + img_size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            img_size, 2835, 2835, 0, 0))
        bgr = rgb[::-1, :, ::-1]
        padding = b"\x00" * pad
        for r in bgr:
            f.write(r.tobytes())
            if pad:
                f.write(padding)


def write_tga(path, rgb: np.ndarray) -> None:
    """Uncompressed 24-bit TGA (native fast path)."""
    nat = _native()
    if nat is not None:
        with open(path, "wb") as f:
            f.write(nat.encode_tga_native(rgb))
        return
    write_tga_py(path, rgb)


def write_tga_py(path, rgb: np.ndarray) -> None:
    """Uncompressed 24-bit TGA (top-down, BGR)."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0,
                            w, h, 24, 0x20))
        f.write(rgb[:, :, ::-1].tobytes())


def write_png(path, rgb: np.ndarray) -> None:
    """PNG, RGB8 (native fast path: sub-filtered, zlib level 3 — the
    speed/ratio point measured in tests/test_native_export.py)."""
    nat = _native()
    if nat is not None:
        with open(path, "wb") as f:
            f.write(nat.encode_png_native(rgb, level=3))
        return
    write_png_py(path, rgb)


def write_png_py(path, rgb: np.ndarray) -> None:
    """PNG, RGB8, zlib-deflated with per-row filter 0."""
    h, w, _ = rgb.shape

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload))

    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
        axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                           0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# baseline JPEG encoder (4:2:0, standard tables)

_ZZ = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                54, 47, 55, 62, 63])

# Annex K.1/K.2 base quantisation tables
_QY = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99], dtype=np.int32)
_QC = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    dtype=np.int32)

# Annex K.3 standard Huffman tables: (bits, values)
_HT = {
    ("dc", 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                list(range(12))),
    ("dc", 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                list(range(12))),
    ("ac", 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
                [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
                 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
                 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1,
                 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
                 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
                 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
                 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
                 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
                 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a,
                 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
                 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
                 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
                 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
                 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
                 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
                 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
                 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1,
                 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]),
    ("ac", 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
                 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
                 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1,
                 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
                 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
                 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
                 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47,
                 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
                 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
                 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
                 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
                 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
                 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa,
                 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
                 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
                 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
                 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
                 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]),
}


def _huff_codes(bits, values):
    codes = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            codes[values[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return codes


def _scale_q(q, quality):
    quality = min(max(quality, 1), 100)
    s = 5000 // quality if quality < 50 else 200 - quality * 2
    out = (q * s + 50) // 100
    return np.clip(out, 1, 255)


_DCT_C = np.zeros((8, 8))
for _u in range(8):
    for _x in range(8):
        _DCT_C[_u, _x] = np.cos((2 * _x + 1) * _u * np.pi / 16) * \
            (np.sqrt(0.5) if _u == 0 else 1.0) * 0.5


class _BitSink:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:
                self.buf.append(0)      # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)


def _encode_blocks(sink, blocks, q, dc_codes, ac_codes, pred):
    """blocks: [N, 8, 8] level-shifted samples."""
    for blk in blocks:
        coef = _DCT_C @ blk @ _DCT_C.T
        quant = np.round(coef / q.reshape(8, 8)).astype(np.int32)
        zz = quant.reshape(64)[_ZZ]
        diff = int(zz[0]) - pred
        pred = int(zz[0])
        _put_coef(sink, diff, dc_codes, None)
        run = 0
        last_nz = np.nonzero(zz[1:])[0]
        end = last_nz[-1] + 1 if len(last_nz) else 0
        for k in range(1, end + 1):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c, ln = ac_codes[0xF0]
                sink.put(c, ln)
                run -= 16
            _put_coef(sink, v, ac_codes, run)
            run = 0
        if end < 63:
            c, ln = ac_codes[0x00]
            sink.put(c, ln)
    return pred


def _put_coef(sink, v, codes, run):
    size = int(abs(v)).bit_length()
    sym = size if run is None else ((run << 4) | size)
    c, ln = codes[sym]
    sink.put(c, ln)
    if size:
        if v < 0:
            v = v + (1 << size) - 1
        sink.put(v & ((1 << size) - 1), size)


def write_jpeg(path, y, cb, cr, quality=75) -> None:
    """Baseline JPEG, 4:2:0 from decoded planes (native fast path)."""
    nat = _native()
    if nat is not None:
        with open(path, "wb") as f:
            f.write(nat.encode_jpeg_native(y, cb, cr, quality))
        return
    write_jpeg_py(path, y, cb, cr, quality)


def write_jpeg_py(path, y, cb, cr, quality=75) -> None:
    """Baseline JPEG, YCbCr 4:2:0 directly from decoded planes."""
    h, w = y.shape
    qy = _scale_q(_QY, quality)
    qc = _scale_q(_QC, quality)

    def pad_to(arr, mult):
        hh, ww = arr.shape
        ph = (mult - hh % mult) % mult
        pw = (mult - ww % mult) % mult
        return np.pad(arr, ((0, ph), (0, pw)), mode="edge")

    yp = pad_to(y, 16).astype(np.float64) - 128.0
    cbp = pad_to(cb, 8).astype(np.float64) - 128.0
    crp = pad_to(cr, 8).astype(np.float64) - 128.0

    out = bytearray()
    out += b"\xff\xd8"                                   # SOI
    for qt, tid in ((qy, 0), (qc, 1)):
        out += b"\xff\xdb" + struct.pack(">HB", 67, tid)
        out += bytes(int(qt[z]) for z in _ZZ)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, w, 3)
    out += bytes([1, 0x22, 0])                           # Y 2x2, Q0
    out += bytes([2, 0x11, 1])                           # Cb 1x1, Q1
    out += bytes([3, 0x11, 1])
    for (kind, tid), (bits, values) in _HT.items():
        out += b"\xff\xc4" + struct.pack(
            ">HB", 19 + len(values),
            (0x10 if kind == "ac" else 0) | tid)
        out += bytes(bits) + bytes(values)
    out += b"\xff\xda" + struct.pack(">HB", 12, 3)
    out += bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])

    dc_y = _huff_codes(*_HT[("dc", 0)])
    ac_y = _huff_codes(*_HT[("ac", 0)])
    dc_c = _huff_codes(*_HT[("dc", 1)])
    ac_c = _huff_codes(*_HT[("ac", 1)])
    sink = _BitSink()
    py = pc1 = pc2 = 0
    hh, ww = yp.shape
    for my in range(0, hh, 16):
        for mx in range(0, ww, 16):
            yblocks = [yp[my + dy:my + dy + 8, mx + dx:mx + dx + 8]
                       for dy in (0, 8) for dx in (0, 8)]
            py = _encode_blocks(sink, yblocks, qy, dc_y, ac_y, py)
            cy, cx = my // 2, mx // 2
            pc1 = _encode_blocks(sink, [cbp[cy:cy + 8, cx:cx + 8]],
                                 qc, dc_c, ac_c, pc1)
            pc2 = _encode_blocks(sink, [crp[cy:cy + 8, cx:cx + 8]],
                                 qc, dc_c, ac_c, pc2)
    sink.flush()
    out += sink.buf
    out += b"\xff\xd9"                                   # EOI
    with open(path, "wb") as f:
        f.write(out)


# ---------------------------------------------------------------------------
# dispatch (reference export_idr, export.c:618-753)

_EXT = {PictureFormat.JPG: "jpg", PictureFormat.PNG: "png",
        PictureFormat.BMP: "bmp", PictureFormat.TGA: "tga",
        PictureFormat.YUV420: "yuv", PictureFormat.YUV444: "yuv"}


def export_picture(path_base: str, fmt: PictureFormat, y, cb, cr,
                   quality: int = 75, rgb=None) -> str:
    """Write one decoded picture; returns the output path.

    `rgb` (optional): precomputed RGB888 — e.g. converted on device by
    the decode (ops/color.py via mv_decode(want_rgb=True)); when absent
    the RGB formats convert here (native C fast path)."""
    path = f"{path_base}.{_EXT[fmt]}"
    with span("export.picture", 1):
        if fmt == PictureFormat.YUV420:
            write_yuv420(path, y, cb, cr)
        elif fmt == PictureFormat.YUV444:
            write_yuv444(path, y, cb, cr)
        elif fmt in (PictureFormat.BMP, PictureFormat.TGA,
                     PictureFormat.PNG):
            if rgb is None:
                rgb = yuv420_to_rgb(y, cb, cr)
            {PictureFormat.BMP: write_bmp, PictureFormat.TGA: write_tga,
             PictureFormat.PNG: write_png}[fmt](path, rgb)
        elif fmt == PictureFormat.JPG:
            write_jpeg(path, y, cb, cr, quality)
        else:
            raise ValueError(f"unsupported picture format {fmt}")
    trace.info("EXPORT", "wrote %s", path)
    return path

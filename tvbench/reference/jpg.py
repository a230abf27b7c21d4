"""The plain reference of a JPEG thumbnail (`-f jpg`): a baseline JPEG of
given planes at a given quality (ITU-T T.81, quantisers of Annex K, the
IJG quality scaling that mini_thumbnailer's `-q` follows).  check.py
finds this module by the thumbnailer's format and compares `NUMBER`.

`read_jpeg` parses a baseline, 4:2:0 JPEG with Python alone: its frame
header, quantisation tables and the quantised DCT coefficients of every
block.  `check_jpeg` holds a file to the planes the reference decoded:
its size and sampling, and every coefficient against the exact (float64)
DCT of the reference's samples, divided by the quality's quantiser.  A correct encoder rounds each of those to the
nearest integer, so a coefficient that lies more than a half (and a
margin for the encoder's float32 arithmetic) from it was not made from
these samples at this quality.  Float32 arithmetic gives errors near
1e-4 in these units; the margin is 1e-3.  `encode` writes the JPEG that an exact encoder
makes of given planes: the control's thumbnail (control.py).
"""

from __future__ import annotations

import numpy as np

MARGIN = 1e-3
NUMBER = "jpeg_bad_blocks"     # the number check.py compares

# ITU-T T.81 Annex K.1, in natural (raster) order
_QY = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QC = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])


def _zigzag():
    order = sorted(((x + y, y if (x + y) % 2 else x, y * 8 + x)
                    for y in range(8) for x in range(8)))
    return np.array([k for _, _, k in order])


ZZ = _zigzag()          # ZZ[i] = raster index of zig-zag position i

_DCT = np.array([[np.cos((2 * x + 1) * u * np.pi / 16)
                  * (np.sqrt(0.125) if u == 0 else 0.5)
                  for x in range(8)] for u in range(8)])


def quant_tables(quality: int):
    """(luma, chroma) quantisers in raster order at `quality` (1-100)."""
    q = min(max(int(quality), 1), 100)
    s = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * s + 50) // 100, 1, 255) for t in (_QY, _QC))


def _huffman(bits, values):
    """A 65,536-entry table: 16 peeked bits -> (symbol, code length)."""
    table = [None] * 65536
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            lo = code << (16 - ln)
            entry = (values[k], ln)
            for j in range(lo, lo + (1 << (16 - ln))):
                table[j] = entry
            code += 1
            k += 1
        code <<= 1
    return table


def _unstuff(data: bytes, pos: int):
    """(entropy-coded bytes with 0xFF00 unstuffed, position of the marker
    that ends them)."""
    end = pos
    while True:
        end = data.index(b"\xff", end)
        if data[end + 1] != 0:
            break
        end += 2
    return data[pos:end].replace(b"\xff\x00", b"\xff"), end


def read_jpeg(data: bytes) -> dict:
    """Frame header, tables and coefficients of a baseline JPEG whose scan
    interleaves Y (2x2), Cb and Cr (1x1): {"size": (w, h), "sampling",
    "q": {table id: raster quantisers}, "comp_q": [table id per
    component], "coef": [Y [n, 64], Cb [m, 64], Cr [m, 64]] quantised,
    raster order, blocks in MCU order}.  Raises ValueError on anything
    else."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos, q, huff, frame = 2, {}, {}, None
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at {pos}")
        marker = data[pos + 1]
        seg = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + seg]
        if marker == 0xDB:                               # DQT
            i = 0
            while i < len(body):
                if body[i] >> 4:
                    raise ValueError("16-bit quantisers")
                zz = np.frombuffer(body[i + 1:i + 65], np.uint8)
                raster = np.zeros(64, np.int64)
                raster[ZZ] = zz
                q[body[i] & 15] = raster
                i += 65
        elif marker == 0xC4:                             # DHT
            i = 0
            while i < len(body):
                bits = list(body[i + 1:i + 17])
                n = sum(bits)
                huff[(body[i] >> 4, body[i] & 15)] = _huffman(
                    bits, list(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xC0:                             # SOF0
            h = int.from_bytes(body[1:3], "big")
            w = int.from_bytes(body[3:5], "big")
            comps = [tuple(body[6 + 3 * k:9 + 3 * k])
                     for k in range(body[5])]
            frame = (w, h, comps)
        elif marker == 0xDA:                             # SOS
            scan = [tuple(body[1 + 2 * k:3 + 2 * k])
                    for k in range(body[0])]
            pos += 2 + seg
            break
        elif marker in (0xC1, 0xC2, 0xC3, 0xDD):
            raise ValueError(f"marker {marker:#x} is not baseline")
        pos += 2 + seg
    if frame is None:
        raise ValueError("no SOF0")
    w, h, comps = frame
    if [c[1] for c in comps] != [0x22, 0x11, 0x11] or len(scan) != 3:
        raise ValueError(f"not 4:2:0 YCbCr: {comps}, scan {scan}")
    ecs, end = _unstuff(data, pos)
    if data[end:end + 2] != b"\xff\xd9":
        raise ValueError(f"the scan ends in {data[end:end + 2]!r}, not EOI")
    tabs = [(huff[(0, s[1] >> 4)], huff[(1, s[1] & 15)]) for s in scan]
    mcux, mcuy = (w + 15) // 16, (h + 15) // 16
    n_mcu = mcux * mcuy
    coef = [np.zeros((4 * n_mcu, 64), np.int64),
            np.zeros((n_mcu, 64), np.int64), np.zeros((n_mcu, 64), np.int64)]
    buf = ecs + b"\x00\x00\x00\x00"
    bitpos = 0
    frombytes = int.from_bytes

    def peek16(p):
        return (frombytes(buf[p >> 3:(p >> 3) + 3], "big")
                >> (8 - (p & 7))) & 0xFFFF

    def receive(p, size):
        v = (frombytes(buf[p >> 3:(p >> 3) + 4], "big")
             >> (32 - (p & 7) - size)) & ((1 << size) - 1)
        return v - (1 << size) + 1 if v < (1 << (size - 1)) else v

    pred = [0, 0, 0]
    order = [0, 0, 0, 0, 1, 2]
    for m in range(n_mcu):
        for b, c in enumerate(order):
            dc_t, ac_t = tabs[c]
            out = coef[c][4 * m + b if c == 0 else m]
            sym, ln = dc_t[peek16(bitpos)]
            bitpos += ln
            if sym:
                pred[c] += receive(bitpos, sym)
                bitpos += sym
            out[0] = pred[c]
            k = 1
            while k < 64:
                rs, ln = ac_t[peek16(bitpos)]
                bitpos += ln
                size = rs & 15
                if size == 0:
                    if rs == 0xF0:
                        k += 16
                        continue
                    break                                # EOB
                k += rs >> 4
                out[ZZ[k]] = receive(bitpos, size)
                bitpos += size
                k += 1
    if (bitpos + 7) // 8 > len(ecs):
        raise ValueError("the scan ends before its last block")
    return {"size": (w, h), "q": q, "comp_q": [c[2] for c in comps],
            "coef": coef}


def _blocks(plane, mcu: int):
    """The 8x8 blocks of `plane`, edge-padded to a multiple of `mcu`, in
    the order a 4:2:0 scan visits them (Y: 2x2 blocks per MCU)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128.0,
               ((0, -h % mcu), (0, -w % mcu)), mode="edge")
    H, W = p.shape
    if mcu == 16:
        t = p.reshape(H // 16, 2, 8, W // 16, 2, 8).transpose(0, 3, 1, 4, 2,
                                                               5)
    else:
        t = p.reshape(H // 8, 1, 8, W // 8, 1, 8).transpose(0, 3, 1, 4, 2, 5)
    return t.reshape(-1, 8, 8)


def exact(planes, quality: int):
    """The exact DCT of each block of display-cropped `planes` (Y, Cb,
    Cr) over its quantiser at `quality`: [Y [n, 64], Cb [m, 64], Cr [m,
    64]], raster order within a block, blocks in MCU order."""
    qy, qc = quant_tables(quality)
    out = []
    for plane, qt, mcu in zip(planes, (qy, qc, qc), (16, 8, 8)):
        blocks = _blocks(plane, mcu)
        e = np.einsum("ux,nxy,vy->nuv", _DCT, blocks, _DCT)
        out.append(e.reshape(len(blocks), 64) / qt)
    return out


def bad_blocks(coef, want) -> tuple:
    """(blocks whose quantised coefficients `coef` are not all the
    rounding of `want`, the largest distance beyond a half)."""
    bad, worst = 0, 0.0
    for c, w in zip(coef, want):
        excess = np.abs(c - w) - 0.5
        bad += int((excess > MARGIN).any(axis=1).sum())
        worst = max(worst, float(excess.max()))
    return bad, worst


def check_file(data: bytes, planes, quality: int) -> dict:
    """Hold JPEG bytes to display-cropped `planes` (Y, Cb, Cr) at
    `quality`: {"blocks": the picture's 8x8 blocks, "bad_blocks": blocks
    whose coefficients are not each the rounding of the exact DCT over
    the quality's quantiser (every block, where the file is not a baseline
    4:2:0 JPEG of the picture's size), "worst_excess"}.  Against the
    quality's own tables, a file written with other tables fails too."""
    want = exact(planes, quality)
    blocks = sum(len(w) for w in want)
    try:
        j = read_jpeg(data)
        if j["size"] != (planes[0].shape[1], planes[0].shape[0]):
            raise ValueError(f"size {j['size']}")
    except (ValueError, IndexError, KeyError, TypeError) as e:
        return {"blocks": blocks, "bad_blocks": blocks,
                "worst_excess": float("inf"), "error": str(e)}
    bad, worst = bad_blocks(j["coef"], want)
    return {"blocks": blocks, "bad_blocks": bad, "worst_excess": worst}


def blocks(width: int, height: int) -> int:
    """The 8x8 blocks of a 4:2:0 picture of width x height samples."""
    return 6 * (-(-width // 16)) * (-(-height // 16))


def _code_table(n_symbols: int, length: int):
    """(BITS, {symbol index: code}) of a table whose codes all have
    `length` bits (none all ones)."""
    assert n_symbols < 1 << length
    bits = [0] * 16
    bits[length - 1] = n_symbols
    return bits, [format(k, f"0{length}b") for k in range(n_symbols)]


_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | z for r in range(16)
                              for z in range(1, 11)]


def _value_bits(v: int):
    """(size category, its extra bits) of a coefficient value."""
    size = abs(v).bit_length()
    if not size:
        return 0, ""
    return size, format(v if v > 0 else v + (1 << size) - 1, f"0{size}b")


def encode(planes, quality: int) -> bytes:
    """A baseline 4:2:0 JPEG of display-cropped `planes` (Y, Cb, Cr) at
    `quality`, each coefficient the rounding of the exact DCT over the
    quality's quantiser, with fixed-length Huffman codes of its own."""
    h, w = planes[0].shape
    coef = [np.rint(c).astype(np.int64) for c in exact(planes, quality)]
    qy, qc = quant_tables(quality)
    dc_bits, dc_code = _code_table(len(_DC_SYMBOLS), 4)
    ac_bits, ac_code = _code_table(len(_AC_SYMBOLS), 8)
    dc = dict(zip(_DC_SYMBOLS, dc_code))
    ac = dict(zip(_AC_SYMBOLS, ac_code))
    out, pred = [], [0, 0, 0]
    order = [0, 0, 0, 0, 1, 2]
    for m in range(len(coef[1])):
        for b, c in enumerate(order):
            zz = coef[c][4 * m + b if c == 0 else m][ZZ].tolist()
            size, extra = _value_bits(zz[0] - pred[c])
            pred[c] = zz[0]
            out += (dc[size], extra)
            run = 0
            for v in zz[1:]:
                if not v:
                    run += 1
                    continue
                while run > 15:
                    out.append(ac[0xF0])
                    run -= 16
                size, extra = _value_bits(v)
                out += (ac[run << 4 | size], extra)
                run = 0
            if run:
                out.append(ac[0x00])
    bits = "".join(out)
    bits += "1" * (-len(bits) % 8)
    ecs = int(bits, 2).to_bytes(len(bits) // 8, "big").replace(
        b"\xff", b"\xff\x00")

    def segment(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + body

    dqt = b"".join(bytes([k]) + bytes(t[ZZ].tolist())
                   for k, t in enumerate((qy, qc)))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + \
        bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls << 4 | k, *bits_, *symbols])
                   for k in range(2)
                   for cls, bits_, symbols in ((0, dc_bits, _DC_SYMBOLS),
                                               (1, ac_bits, _AC_SYMBOLS)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + segment(0xDB, dqt) + segment(0xC0, sof)
            + segment(0xC4, dht) + segment(0xDA, sos) + ecs + b"\xff\xd9")

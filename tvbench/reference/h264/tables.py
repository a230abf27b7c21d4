"""Standard ITU-T H.264 constant tables used by the decoder.

All data here is mandated by the H.264 specification (table numbers cited
per item); every conforming decoder carries identical values.
Reference counterparts: minivideo/src/decoder/h264/h264_transform.c
(normAdjust, scan orders), h264_parameterset.c (default scaling lists).
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------------
# Inverse scan orders (spec 8.5.6 / 8.5.7, Figure 8-8).
# ZIGZAG_4x4[k] = raster index of the k-th coefficient in zig-zag order.
ZIGZAG_4x4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32)

ZIGZAG_8x8 = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
     12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
     35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
     58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int32)

# ----------------------------------------------------------------------------
# Dequantisation norm-adjust matrices (spec 8.5.9, Table "v" values).
# normAdjust4x4(m, i, j) built from V4[m] by position class:
#   class 0: (i,j) both even -> v[0]; class 1: both odd -> v[1]; else v[2].
_V4 = np.array([
    [10, 16, 13], [11, 18, 14], [13, 20, 16],
    [14, 23, 18], [16, 25, 20], [18, 29, 23]], dtype=np.int32)

# 8x8 (spec 8.5.9 eq 8-253), position classes built below.
_V8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43]], dtype=np.int32)


def _build_norm_adjust_4x4() -> np.ndarray:
    """normAdjust4x4[m, i, j] for m in 0..5 (spec 8.5.9 eq 8-252)."""
    out = np.zeros((6, 4, 4), dtype=np.int32)
    for m in range(6):
        for i in range(4):
            for j in range(4):
                if i % 2 == 0 and j % 2 == 0:
                    out[m, i, j] = _V4[m, 0]
                elif i % 2 == 1 and j % 2 == 1:
                    out[m, i, j] = _V4[m, 1]
                else:
                    out[m, i, j] = _V4[m, 2]
    return out


def _build_norm_adjust_8x8() -> np.ndarray:
    """normAdjust8x8[m, i, j] for m in 0..5 (spec 8.5.9 eq 8-253)."""
    out = np.zeros((6, 8, 8), dtype=np.int32)
    for m in range(6):
        for i in range(8):
            for j in range(8):
                if i % 4 == 0 and j % 4 == 0:
                    v = _V8[m, 0]
                elif i % 2 == 1 and j % 2 == 1:
                    v = _V8[m, 1]
                elif i % 4 == 2 and j % 4 == 2:
                    v = _V8[m, 2]
                elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                    v = _V8[m, 3]
                elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                    v = _V8[m, 4]
                else:
                    v = _V8[m, 5]
                out[m, i, j] = v
    return out


NORM_ADJUST_4x4 = _build_norm_adjust_4x4()
NORM_ADJUST_8x8 = _build_norm_adjust_8x8()

# ----------------------------------------------------------------------------
# Default scaling lists (spec Table 7-2 / 7-3), in zig-zag scan order.
DEFAULT_4x4_INTRA = np.array(
    [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
    dtype=np.int32)
DEFAULT_4x4_INTER = np.array(
    [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34],
    dtype=np.int32)
DEFAULT_8x8_INTRA = np.array(
    [6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
     23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
     27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
     31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42],
    dtype=np.int32)
DEFAULT_8x8_INTER = np.array(
    [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
     21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
     24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
     27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35],
    dtype=np.int32)

FLAT_16 = np.full(16, 16, dtype=np.int32)
FLAT_64 = np.full(64, 16, dtype=np.int32)

# ----------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-15): qPI -> QPC for qPI in 0..51.
QPC_FROM_QPI = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38,
     38, 38, 39, 39, 39, 39], dtype=np.int32)


def chroma_qp(qpy: int, chroma_qp_offset: int) -> int:
    qpi = min(max(qpy + chroma_qp_offset, 0), 51)
    return int(QPC_FROM_QPI[qpi])


# ----------------------------------------------------------------------------
# Macroblock partition / block scan helpers.
# Raster position (x, y) in luma samples of 4x4 block `luma4x4BlkIdx`
# (spec 6.4.3: inverse 4x4 luma block scan).
def _build_blk4x4_pos():
    pos = np.zeros((16, 2), dtype=np.int32)
    for idx in range(16):
        # inverse raster within 8x8 sub-block structure
        x = ((idx // 4) % 2) * 8 + (idx % 2) * 4
        y = (idx // 8) * 8 + ((idx // 2) % 2) * 4
        pos[idx] = (x, y)
    return pos


BLK4x4_POS = _build_blk4x4_pos()          # luma4x4BlkIdx -> (x, y)

# 8x8 block positions: luma8x8BlkIdx -> (x, y)
BLK8x8_POS = np.array([(0, 0), (8, 0), (0, 8), (8, 8)], dtype=np.int32)

# chroma 4x4 block positions within 8x8 chroma plane (raster)
CHROMA_BLK_POS = np.array([(0, 0), (4, 0), (0, 4), (4, 4)], dtype=np.int32)

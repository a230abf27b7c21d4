"""Integer inverse transforms + dequantisation, numpy oracle (spec 8.5).

Copy of minivideo_tpu/models/h264/transform_np.py (numpy only): the
host-side reference that the `np` engine (recon_np.py) uses; the torch
transforms of ops/transform.py must give the same integers.  Reference:
minivideo/src/decoder/h264/h264_transform.c (dequant :924-1294, idct
:1145-1396, DC transforms :121-438).  All arithmetic is exact
int32/int64 per spec: no floats.
"""

from __future__ import annotations

import numpy as np

from .params import zigzag_to_raster_4x4, zigzag_to_raster_8x8
from .tables import NORM_ADJUST_4x4, NORM_ADJUST_8x8


def level_scale_4x4(scaling_list_zz: np.ndarray) -> np.ndarray:
    """LevelScale4x4[m, i, j] = weightScale(i,j) * normAdjust4x4(m,i,j)
    (spec 8.5.9).  `scaling_list_zz` is in zig-zag order (as parsed)."""
    w = zigzag_to_raster_4x4(scaling_list_zz)           # [4,4]
    return w[None, :, :] * NORM_ADJUST_4x4              # [6,4,4]


def level_scale_8x8(scaling_list_zz: np.ndarray) -> np.ndarray:
    w = zigzag_to_raster_8x8(scaling_list_zz)           # [8,8]
    return w[None, :, :] * NORM_ADJUST_8x8              # [6,8,8]


def dequant_4x4(c: np.ndarray, qp: int, ls: np.ndarray,
                skip_dc: bool = False) -> np.ndarray:
    """Scale 4x4 residual levels (spec 8.5.12.1, eq 8-270).

    `c` is the raster-order level block; `ls` is LevelScale4x4 [6,4,4].
    If `skip_dc`, position (0,0) is preserved (DC comes from the separate
    DC transform path)."""
    m = qp % 6
    d = np.asarray(c, dtype=np.int64)
    if qp >= 24:
        out = (d * ls[m]) << (qp // 6 - 4)
    else:
        out = (d * ls[m] + (1 << (3 - qp // 6))) >> (4 - qp // 6)
    if skip_dc:
        out[0, 0] = d[0, 0]
    return out.astype(np.int64)


def dequant_8x8(c: np.ndarray, qp: int, ls8: np.ndarray) -> np.ndarray:
    """Scale 8x8 residual levels (spec 8.5.13.1, eq 8-286)."""
    m = qp % 6
    d = np.asarray(c, dtype=np.int64)
    if qp >= 36:
        return (d * ls8[m]) << (qp // 6 - 6)
    return (d * ls8[m] + (1 << (5 - qp // 6))) >> (6 - qp // 6)


_HAD4 = np.array([[1, 1, 1, 1],
                  [1, 1, -1, -1],
                  [1, -1, -1, 1],
                  [1, -1, 1, -1]], dtype=np.int64)


def luma_dc_transform(c: np.ndarray, qp: int, ls: np.ndarray) -> np.ndarray:
    """Intra16x16 luma DC: 4x4 inverse Hadamard + scaling (spec 8.5.10).

    Returns dcY [4,4]; dcY[i][j] feeds the 4x4 block at raster (i, j)."""
    f = _HAD4 @ np.asarray(c, dtype=np.int64) @ _HAD4
    scale = int(ls[qp % 6, 0, 0])
    if qp >= 36:
        return (f * scale) << (qp // 6 - 6)
    return (f * scale + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc_transform(c: np.ndarray, qp: int, ls: np.ndarray) -> np.ndarray:
    """Chroma DC 2x2 inverse transform + scaling, 4:2:0 (spec 8.5.11)."""
    h2 = np.array([[1, 1], [1, -1]], dtype=np.int64)
    f = h2 @ np.asarray(c, dtype=np.int64) @ h2
    scale = int(ls[qp % 6, 0, 0])
    return ((f * scale) << (qp // 6)) >> 5


def idct_4x4(d: np.ndarray) -> np.ndarray:
    """4x4 inverse core transform (spec 8.5.12.2).  Input: dequantised
    levels [...,4,4]; output: residual (h + 32) >> 6."""
    d = np.asarray(d, dtype=np.int64)
    # horizontal (rows): operate along last axis
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    # vertical (columns)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)
    return (h + 32) >> 6


def _idct8_1d(d, axis_stack):
    """One 8-point inverse transform stage (spec 8.5.13.2)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    a0 = d0 + d4
    a4 = d0 - d4
    a2 = (d2 >> 1) - d6
    a6 = d2 + (d6 >> 1)
    b0 = a0 + a6
    b2 = a4 + a2
    b4 = a4 - a2
    b6 = a0 - a6
    a1 = -d3 + d5 - d7 - (d7 >> 1)
    a3 = d1 + d7 - d3 - (d3 >> 1)
    a5 = -d1 + d7 + d5 + (d5 >> 1)
    a7 = d3 + d5 + d1 + (d1 >> 1)
    b1 = a1 + (a7 >> 2)
    b7 = a7 - (a1 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                     b6 - b1, b4 - b3, b2 - b5, b0 - b7], axis=axis_stack)


def idct_8x8(d: np.ndarray) -> np.ndarray:
    """8x8 inverse transform (spec 8.5.13.2).  Input [...,8,8] dequantised;
    output residual (h + 32) >> 6."""
    d = np.asarray(d, dtype=np.int64)
    rows = [d[..., :, k] for k in range(8)]
    f = _idct8_1d(rows, axis_stack=-1)
    cols = [f[..., k, :] for k in range(8)]
    h = _idct8_1d(cols, axis_stack=-2)
    return (h + 32) >> 6


def clip_pixel(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255)

"""Dequantisation scale tables and the 8-point IDCT butterfly.

Port of the parts of minivideo_tpu/ops/transform.py that the slab
residual stage (ops/slab.py) uses.  `_idct8_stage_t` works on any
operands with integer +, - and >> (torch tensors, numpy arrays, ints).
"""

from __future__ import annotations

import numpy as np

from ..models.h264.params import zigzag_to_raster_4x4, zigzag_to_raster_8x8
from ..models.h264.tables import NORM_ADJUST_4x4, NORM_ADJUST_8x8


def level_scale_4x4_np(scaling_list_zz) -> np.ndarray:
    w = zigzag_to_raster_4x4(np.asarray(scaling_list_zz))
    return (w[None] * NORM_ADJUST_4x4).astype(np.int32)       # [6,4,4]


def level_scale_8x8_np(scaling_list_zz) -> np.ndarray:
    w = zigzag_to_raster_8x8(np.asarray(scaling_list_zz))
    return (w[None] * NORM_ADJUST_8x8).astype(np.int32)       # [6,8,8]


def _idct8_stage_t(rows):
    """One 8-point pass of the 8x8 inverse transform (spec 8.5.13.2)."""
    d0, d1, d2, d3, d4, d5, d6, d7 = rows
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
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7]

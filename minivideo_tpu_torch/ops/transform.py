"""Batched integer dequantisation + inverse transforms (torch, exact
int32).

Port of minivideo_tpu/ops/transform.py: the scale tables, and every
transform as torch ops on the input's device, bit-exact with the numpy
oracle (models/h264/transform_np.py).  All blocks of all macroblocks of
all frames transform in one batched pass: this phase has no spatial
dependencies.  The `*_t` functions work on "components-first" tensors
[blk_h, blk_w, N] (N = all blocks, flattened), the public wrappers take
[..., h, w].  The JAX module's Hadamards are int32 einsums; here they are
written as adds, so no matmul precision setting can touch them.
`_idct8_stage_t` works on any operands with integer +, - and >> (torch
tensors, numpy arrays, ints): ops/slab.py uses it too.

Reference: minivideo/src/decoder/h264/h264_transform.c (dequant
:924-1294, idct :1145-1396).
"""

from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# components-first internals ([blk_h, blk_w, N], N = all blocks)


def to_comp_first(x, h, w):
    """[..., h, w] -> ([h, w, N], lead_shape)."""
    lead = tuple(x.shape[:-2])
    return x.reshape((-1, h, w)).permute(1, 2, 0), lead


def from_comp_first(t, lead, h, w):
    return t.permute(2, 0, 1).reshape(tuple(lead) + (h, w))


def _floor_div6(qp):
    return torch.div(qp, 6, rounding_mode="floor")


def _dequant_t(ct, qp, ls, shift0):
    """(ct * LevelScale) shifted by qp // 6 - shift0, rounding when the
    shift is to the right (spec 8-270 with shift0 = 4, 8-286 with 6)."""
    m = torch.remainder(qp, 6).long()
    div = _floor_div6(qp)
    scale = ls.permute(1, 2, 0)[:, :, m]            # [h, w, N]
    shift_l = (div - shift0).clamp(min=0)
    shift_r = (shift0 - div).clamp(min=0)
    rnd = torch.where(div < shift0, 1 << (shift0 - 1 - div).clamp(min=0),
                      torch.zeros_like(div))
    prod = ct * scale
    return torch.where(qp >= 6 * shift0, prod << shift_l,
                       (prod + rnd) >> shift_r)


def dequant_4x4_t(ct, qp, ls):
    """ct [4, 4, N] int32; qp [N] int32; ls [6, 4, 4] (spec 8.5.12.1)."""
    return _dequant_t(ct, qp, ls, 4)


def dequant_8x8_t(ct, qp, ls8):
    """ct [8, 8, N]; qp [N]; ls8 [6, 8, 8] (spec 8.5.13.1)."""
    return _dequant_t(ct, qp, ls8, 6)


def idct_4x4_t(t):
    """4x4 inverse core transform on [4, 4, N] (spec 8.5.12.2)."""
    e0 = t[:, 0] + t[:, 2]                         # [4, N]
    e1 = t[:, 0] - t[:, 2]
    e2 = (t[:, 1] >> 1) - t[:, 3]
    e3 = t[:, 1] + (t[:, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=1)
    g0 = f[0] + f[2]                               # [4, N]
    g1 = f[0] - f[2]
    g2 = (f[1] >> 1) - f[3]
    g3 = f[1] + (f[3] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=0)
    return (h + 32) >> 6


def idct_8x8_t(t):
    """8x8 inverse transform on [8, 8, N] (spec 8.5.13.2)."""
    f = torch.stack(_idct8_stage_t([t[:, k] for k in range(8)]), dim=1)
    h = torch.stack(_idct8_stage_t([f[k] for k in range(8)]), dim=0)
    return (h + 32) >> 6


# ---------------------------------------------------------------------------
# public wrappers ([..., h, w] int tensors; qp broadcastable to [...])


def _as_i32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32)


def dequant_4x4(c, qp, ls):
    """Vectorised 8.5.12.1.  c: [..., 4, 4]; qp: [...] broadcastable;
    ls: [6, 4, 4]."""
    c = c.to(torch.int32)
    qp = _as_i32(qp, c.device).expand(c.shape[:-2])
    ct, lead = to_comp_first(c, 4, 4)
    out = dequant_4x4_t(ct, qp.reshape(-1), _as_i32(ls, c.device))
    return from_comp_first(out, lead, 4, 4)


def dequant_8x8(c, qp, ls8):
    """Vectorised 8.5.13.1.  c: [..., 8, 8]; ls8: [6, 8, 8]."""
    c = c.to(torch.int32)
    qp = _as_i32(qp, c.device).expand(c.shape[:-2])
    ct, lead = to_comp_first(c, 8, 8)
    out = dequant_8x8_t(ct, qp.reshape(-1), _as_i32(ls8, c.device))
    return from_comp_first(out, lead, 8, 8)


def _had4(v, dim):
    """4-point Hadamard [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]]
    along `dim` (size 4), as adds."""
    x0, x1, x2, x3 = v.unbind(dim)
    s01, s23, d01, d23 = x0 + x1, x2 + x3, x0 - x1, x2 - x3
    return torch.stack([s01 + s23, s01 - s23, d01 - d23, d01 + d23], dim)


def _had2(v, dim):
    x0, x1 = v.unbind(dim)
    return torch.stack([x0 + x1, x0 - x1], dim)


def _dc_scale(qp, ls):
    """LevelScale(qp % 6, 0, 0) per element of qp."""
    return ls[:, 0, 0][torch.remainder(qp, 6).long()]


def luma_dc_transform(c, qp, ls):
    """Intra16x16 luma DC: 4x4 Hadamard + scaling (spec 8.5.10).
    c: [..., 4, 4]; qp: [...]; returns dcY [..., 4, 4]."""
    c = c.to(torch.int32)
    qp = _as_i32(qp, c.device)
    f = _had4(_had4(c, -2), -1)
    scale = _dc_scale(qp, _as_i32(ls, c.device))[..., None, None]
    div = _floor_div6(qp)[..., None, None]
    shift_l = (div - 6).clamp(min=0)
    shift_r = (6 - div).clamp(min=0)
    rnd = torch.where(div < 6, 1 << (5 - div).clamp(min=0),
                      torch.zeros_like(div))
    return torch.where(qp[..., None, None] >= 36, (f * scale) << shift_l,
                       (f * scale + rnd) >> shift_r)


def chroma_dc_transform(c, qp, ls):
    """Chroma DC 2x2 transform + scaling, 4:2:0 (spec 8.5.11).
    c: [..., 2, 2]; qp is QPC [...]."""
    c = c.to(torch.int32)
    qp = _as_i32(qp, c.device)
    f = _had2(_had2(c, -2), -1)
    scale = _dc_scale(qp, _as_i32(ls, c.device))[..., None, None]
    return ((f * scale) << _floor_div6(qp)[..., None, None]) >> 5


def idct_4x4(d):
    """4x4 inverse core transform (spec 8.5.12.2).  d: [..., 4, 4];
    returns (h + 32) >> 6."""
    t, lead = to_comp_first(d.to(torch.int32), 4, 4)
    return from_comp_first(idct_4x4_t(t), lead, 4, 4)


def idct_8x8(d):
    """8x8 inverse transform (spec 8.5.13.2).  d: [..., 8, 8]."""
    t, lead = to_comp_first(d.to(torch.int32), 8, 8)
    return from_comp_first(idct_8x8_t(t), lead, 8, 8)

"""Spatial neighbour derivations (spec 6.4) and intra mode prediction
(spec 8.3.1.1 / 8.3.2.1) for the fixture encoder.

Copies of minivideo_tpu/models/h264/spatial.py and of `IntraModeResolver`
from minivideo_tpu/models/h264/syntax.py: the encoder mirrors the
decoder's mode-prediction state to choose its prev_intra_pred_mode codes.
"""

from __future__ import annotations

from ..models.h264.syntax import (KIND_I4x4, KIND_I8x8, MODE_DC,
                                  FrameSyntax)
from ..models.h264.tables import BLK4x4_POS

# neighbor identifiers
A = 0  # left
B = 1  # up


def mb_neighbors(mb_addr: int, width_mbs: int, first_mb: int):
    """(mbAddrA, mbAddrB) with -1 if unavailable (spec 6.4.9).

    Availability requires the neighbor to exist in the frame and to be in
    the same slice (addr >= first_mb; slices cover a contiguous MB range in
    decoding order).  Reference: deriv_macroblockneighbours_availability
    (h264_spatial.c:333-428).
    """
    x = mb_addr % width_mbs
    y = mb_addr // width_mbs
    mb_a = mb_addr - 1 if x > 0 else -1
    mb_b = mb_addr - width_mbs if y > 0 else -1
    if mb_a < first_mb:
        mb_a = -1
    if mb_b < first_mb:
        mb_b = -1
    return mb_a, mb_b


def luma4x4_neighbor(mb_addr: int, blk_idx: int, which: int,
                     width_mbs: int, first_mb: int):
    """Neighbor (mbAddrN, luma4x4BlkIdxN) of a 4x4 luma block (spec 6.4.11.4).

    `which` is A (left) or B (up).  Returns (-1, -1) if unavailable.
    Reference: deriv_4x4lumablocks (h264_spatial.c:461-...).
    """
    x, y = int(BLK4x4_POS[blk_idx][0]), int(BLK4x4_POS[blk_idx][1])
    xn = x - 4 if which == A else x
    yn = y if which == A else y - 4
    if xn < 0:
        mb_a, _ = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_a < 0:
            return -1, -1
        return mb_a, _blk4x4_at(xn + 16, yn)
    if yn < 0:
        _, mb_b = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_b < 0:
            return -1, -1
        return mb_b, _blk4x4_at(xn, yn + 16)
    return mb_addr, _blk4x4_at(xn, yn)


def _blk4x4_at(x: int, y: int) -> int:
    """Inverse of BLK4x4_POS: luma4x4BlkIdx covering luma position (x, y)
    (spec 6.4.13.1)."""
    return (8 * (y // 8) + 4 * (x // 8)
            + 2 * ((y % 8) // 4) + ((x % 8) // 4))


def luma8x8_neighbor(mb_addr: int, blk8_idx: int, which: int,
                     width_mbs: int, first_mb: int):
    """Neighbor (mbAddrN, luma8x8BlkIdxN) of an 8x8 luma block
    (spec 6.4.11.2)."""
    x = (blk8_idx % 2) * 8
    y = (blk8_idx // 2) * 8
    xn = x - 8 if which == A else x
    yn = y if which == A else y - 8
    if xn < 0:
        mb_a, _ = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_a < 0:
            return -1, -1
        return mb_a, ((yn // 8) * 2 + (xn + 16) // 8)
    if yn < 0:
        _, mb_b = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_b < 0:
            return -1, -1
        return mb_b, (((yn + 16) // 8) * 2 + xn // 8)
    return mb_addr, ((yn // 8) * 2 + xn // 8)


def chroma4x4_neighbor(mb_addr: int, blk_idx: int, which: int,
                       width_mbs: int, first_mb: int):
    """Neighbor (mbAddrN, chroma4x4BlkIdxN) of a 4x4 chroma block, 4:2:0
    (spec 6.4.11.5).  Chroma blocks are a 2x2 raster in the 8x8 plane.
    Reference: deriv_4x4chromablocks (h264_spatial.c)."""
    x = (blk_idx % 2) * 4
    y = (blk_idx // 2) * 4
    xn = x - 4 if which == A else x
    yn = y if which == A else y - 4
    if xn < 0:
        mb_a, _ = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_a < 0:
            return -1, -1
        return mb_a, ((yn // 4) * 2 + (xn + 8) // 4)
    if yn < 0:
        _, mb_b = mb_neighbors(mb_addr, width_mbs, first_mb)
        if mb_b < 0:
            return -1, -1
        return mb_b, (((yn + 8) // 4) * 2 + xn // 4)
    return mb_addr, ((yn // 4) * 2 + xn // 4)


class IntraModeResolver:
    """Shared mode-prediction logic (spec 8.3.1.1 / 8.3.2.1) used by both
    entropy coders."""

    def __init__(self, fs: FrameSyntax, first_mb: int,
                 constrained_intra: bool):
        self.fs = fs
        self.first_mb = first_mb

    def _mxm_mode(self, mb_n: int, kind_needed: int, blk_n: int,
                  is8x8_blk: bool) -> int:
        fs = self.fs
        if mb_n < 0 or not fs.parsed[mb_n]:
            return -1  # unavailable
        k = fs.mb_kind[mb_n]
        if k == KIND_I4x4:
            idx = blk_n if not is8x8_blk else None
            return int(fs.luma4x4_modes[mb_n, idx])
        if k == KIND_I8x8:
            return int(fs.luma8x8_modes[mb_n, blk_n])
        return MODE_DC  # I16x16 / IPCM neighbors predict DC

    def predicted_4x4_mode(self, mb_addr: int, blk: int) -> int:
        fs = self.fs
        preds = []
        for which in (A, B):
            mb_n, blk_n = luma4x4_neighbor(mb_addr, blk, which,
                                           fs.width_mbs, self.first_mb)
            if mb_n < 0:
                preds.append(-1)
                continue
            k = fs.mb_kind[mb_n]
            if k == KIND_I4x4:
                preds.append(int(fs.luma4x4_modes[mb_n, blk_n]))
            elif k == KIND_I8x8:
                preds.append(int(fs.luma8x8_modes[mb_n, blk_n >> 2]))
            else:
                preds.append(MODE_DC)
        ma, mb = preds
        if ma < 0 or mb < 0:
            return MODE_DC
        return min(ma, mb)

    def predicted_8x8_mode(self, mb_addr: int, blk8: int) -> int:
        fs = self.fs
        preds = []
        for which in (A, B):
            mb_n, blk_n = luma8x8_neighbor(mb_addr, blk8, which,
                                           fs.width_mbs, self.first_mb)
            if mb_n < 0:
                preds.append(-1)
                continue
            k = fs.mb_kind[mb_n]
            if k == KIND_I8x8:
                preds.append(int(fs.luma8x8_modes[mb_n, blk_n]))
            elif k == KIND_I4x4:
                n = 1 if which == A else 2
                preds.append(int(fs.luma4x4_modes[mb_n, blk_n * 4 + n]))
            else:
                preds.append(MODE_DC)
        ma, mb = preds
        if ma < 0 or mb < 0:
            return MODE_DC
        return min(ma, mb)

"""Spatial neighbor derivations for macroblocks and sub-blocks (spec 6.4).

Reference: minivideo/src/decoder/h264/h264_spatial.c — MB neighbor
availability (:333-428), 4x4 luma / chroma block neighbor derivations
(:461-841).  All functions are host-side scalar logic used during the
entropy-parse phase; reconstruction-time neighbor access is handled by the
device wavefront kernels instead.
"""

from __future__ import annotations

from .tables import BLK4x4_POS

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

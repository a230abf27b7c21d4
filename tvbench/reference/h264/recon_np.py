"""Sequential intra reconstruction oracle (numpy, spec-exact): the `np`
engine.

Copy of minivideo_tpu/models/h264/recon_np.py.  Decodes a `FrameSyntax`
into Y/Cb/Cr planes, macroblock by macroblock, with per-4x4-block
availability masks, on the host.  The batched engines (ops/recon_wave.py,
ops/recon_lane.py, ops/recon_fused.py) must produce bit-identical planes.
Reference: h264_intra_prediction.c (all 9 4x4 modes :38-46, 8x8 with
reference filtering :49-61, 16x16 :65-69, chroma :72-76) and
h264_transform.c (picture_construction_process :1398-1623).
"""

from __future__ import annotations

import numpy as np

from .params import PPS, SPS
from .syntax import (FrameSyntax, KIND_I4x4, KIND_I8x8, KIND_I16x16,
                     KIND_IPCM)
from .tables import BLK4x4_POS, chroma_qp
from .transform_np import (chroma_dc_transform, clip_pixel, dequant_4x4,
                           dequant_8x8, idct_4x4, idct_8x8, level_scale_4x4,
                           level_scale_8x8, luma_dc_transform)


class PlaneCtx:
    """A plane plus a decoded-sample availability grid at 4x4 granularity."""

    def __init__(self, h: int, w: int):
        self.plane = np.zeros((h, w), dtype=np.int32)
        self.mask = np.zeros((h // 4, w // 4), dtype=bool)
        # slice id per 4x4 block (intra pred can't cross slice boundaries)
        self.slice_id = np.full((h // 4, w // 4), -1, dtype=np.int32)

    def avail(self, x: int, y: int, cur_slice: int) -> bool:
        """Is sample (x, y) available for prediction (decoded, same slice)?"""
        h, w = self.plane.shape
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        return (self.mask[y // 4, x // 4]
                and self.slice_id[y // 4, x // 4] == cur_slice)

    def mark(self, x: int, y: int, bw: int, bh: int, cur_slice: int) -> None:
        self.mask[y // 4:(y + bh) // 4, x // 4:(x + bw) // 4] = True
        self.slice_id[y // 4:(y + bh) // 4, x // 4:(x + bw) // 4] = cur_slice

    def get(self, x: int, y: int) -> int:
        return int(self.plane[y, x])


def _gather_refs(ctx: PlaneCtx, x0: int, y0: int, size: int, tr_len: int,
                 cur_slice: int):
    """Gather left / top / top-left / top-right reference samples for a
    block at (x0, y0) (spec 8.3.1.2 sample construction).

    Returns (left[size], top[size + tr_len], corner, avail_left, avail_top,
    avail_corner); unavailable top-right samples are substituted with the
    last available top sample per spec."""
    p = ctx.plane
    avail_left = ctx.avail(x0 - 1, y0, cur_slice)
    avail_top = ctx.avail(x0, y0 - 1, cur_slice)
    avail_corner = ctx.avail(x0 - 1, y0 - 1, cur_slice)
    left = (p[y0:y0 + size, x0 - 1].astype(np.int64)
            if avail_left else np.zeros(size, dtype=np.int64))
    if avail_top:
        top = p[y0 - 1, x0:x0 + size].astype(np.int64)
        tr = np.zeros(tr_len, dtype=np.int64)
        for i in range(tr_len):
            xi = x0 + size + i
            if ctx.avail(xi, y0 - 1, cur_slice):
                tr[i] = p[y0 - 1, xi]
            else:
                tr[i] = tr[i - 1] if i > 0 else top[-1]
        top = np.concatenate([top, tr])
    else:
        top = np.zeros(size + tr_len, dtype=np.int64)
    corner = int(p[y0 - 1, x0 - 1]) if avail_corner else 0
    return left, top, corner, avail_left, avail_top, avail_corner


# ---------------------------------------------------------------------------
# 4x4 / 8x8 directional prediction (shared formulas, spec 8.3.1.2 / 8.3.2.2)

def _predict_nxn(mode: int, size: int, left, top, corner,
                 al: bool, at: bool, ac: bool) -> np.ndarray:
    """Compute one NxN intra prediction (modes 0..8).  `top` has length
    2*size (top + top-right, already substituted)."""
    n = size
    pred = np.zeros((n, n), dtype=np.int64)
    ys, xs = np.mgrid[0:n, 0:n]
    # p[x,-1] and p[-1,y] with index -1 meaning the corner p[-1,-1]
    p = lambda x: corner if x == -1 else top[x]
    q = lambda y: corner if y == -1 else left[y]

    if mode == 0:  # Vertical
        if not at:
            raise ValueError("V prediction without top neighbors")
        pred[:, :] = top[None, :n]
    elif mode == 1:  # Horizontal
        if not al:
            raise ValueError("H prediction without left neighbors")
        pred[:, :] = left[:n, None]
    elif mode == 2:  # DC
        if al and at:
            pred[:] = (left[:n].sum() + top[:n].sum() + n) >> \
                (3 if n == 4 else 4)
        elif al:
            pred[:] = (left[:n].sum() + n // 2) >> (2 if n == 4 else 3)
        elif at:
            pred[:] = (top[:n].sum() + n // 2) >> (2 if n == 4 else 3)
        else:
            pred[:] = 128
    elif mode == 3:  # Diagonal down-left
        for y in range(n):
            for x in range(n):
                if x == n - 1 and y == n - 1:
                    pred[y, x] = (p(2 * n - 2) + 3 * p(2 * n - 1) + 2) >> 2
                else:
                    pred[y, x] = (p(x + y) + 2 * p(x + y + 1)
                                  + p(x + y + 2) + 2) >> 2
    elif mode == 4:  # Diagonal down-right
        for y in range(n):
            for x in range(n):
                if x > y:
                    pred[y, x] = (p(x - y - 2) + 2 * p(x - y - 1)
                                  + p(x - y) + 2) >> 2
                elif x < y:
                    pred[y, x] = (q(y - x - 2) + 2 * q(y - x - 1)
                                  + q(y - x) + 2) >> 2
                else:
                    pred[y, x] = (p(0) + 2 * corner + q(0) + 2) >> 2
    elif mode == 5:  # Vertical-right
        for y in range(n):
            for x in range(n):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    pred[y, x] = (p(x - (y >> 1) - 1)
                                  + p(x - (y >> 1)) + 1) >> 1
                elif z >= 0:
                    pred[y, x] = (p(x - (y >> 1) - 2)
                                  + 2 * p(x - (y >> 1) - 1)
                                  + p(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    pred[y, x] = (q(0) + 2 * corner + p(0) + 2) >> 2
                else:
                    idx = y - 2 * x
                    t1 = q(idx - 1)
                    t2 = q(idx - 2)
                    t3 = corner if idx - 3 == -1 else q(idx - 3)
                    pred[y, x] = (t1 + 2 * t2 + t3 + 2) >> 2
    elif mode == 6:  # Horizontal-down
        for y in range(n):
            for x in range(n):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    pred[y, x] = (q(y - (x >> 1) - 1)
                                  + q(y - (x >> 1)) + 1) >> 1
                elif z >= 0:
                    pred[y, x] = (q(y - (x >> 1) - 2)
                                  + 2 * q(y - (x >> 1) - 1)
                                  + q(y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    pred[y, x] = (q(0) + 2 * corner + p(0) + 2) >> 2
                else:
                    idx = x - 2 * y
                    t1 = p(idx - 1)
                    t2 = p(idx - 2)
                    t3 = corner if idx - 3 == -1 else p(idx - 3)
                    pred[y, x] = (t1 + 2 * t2 + t3 + 2) >> 2
    elif mode == 7:  # Vertical-left
        for y in range(n):
            for x in range(n):
                if y % 2 == 0:
                    pred[y, x] = (p(x + (y >> 1))
                                  + p(x + (y >> 1) + 1) + 1) >> 1
                else:
                    pred[y, x] = (p(x + (y >> 1))
                                  + 2 * p(x + (y >> 1) + 1)
                                  + p(x + (y >> 1) + 2) + 2) >> 2
    elif mode == 8:  # Horizontal-up
        zmax = 2 * n - 3  # 13 for 8x8? (4x4: 13 via spec; general below)
        for y in range(n):
            for x in range(n):
                z = x + 2 * y
                if z % 2 == 0 and z < 2 * (n - 1):
                    pred[y, x] = (q(y + (x >> 1))
                                  + q(y + (x >> 1) + 1) + 1) >> 1
                elif z % 2 == 1 and z < 2 * (n - 1) - 1:
                    pred[y, x] = (q(y + (x >> 1))
                                  + 2 * q(y + (x >> 1) + 1)
                                  + q(y + (x >> 1) + 2) + 2) >> 2
                elif z == 2 * (n - 1) - 1:
                    pred[y, x] = (q(n - 2) + 3 * q(n - 1) + 2) >> 2
                else:
                    pred[y, x] = q(n - 1)
    else:
        raise ValueError(f"invalid intra mode {mode}")
    return pred


def _filter_8x8_refs(left, top, corner, al: bool, at: bool, ac: bool):
    """8x8 reference sample filtering (spec 8.3.2.2.1)."""
    fl = left.copy()
    ft = top.copy()
    fc = corner
    if at:
        if ac:
            ft[0] = (corner + 2 * top[0] + top[1] + 2) >> 2
        else:
            ft[0] = (3 * top[0] + top[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (top[x - 1] + 2 * top[x] + top[x + 1] + 2) >> 2
        ft[15] = (top[14] + 3 * top[15] + 2) >> 2
    if ac:
        if at and al:
            fc = (top[0] + 2 * corner + left[0] + 2) >> 2
        elif at:
            fc = (3 * corner + top[0] + 2) >> 2
        elif al:
            fc = (3 * corner + left[0] + 2) >> 2
        # neither: corner kept (cannot happen: corner implies a neighbor MB)
    if al:
        if ac:
            fl[0] = (corner + 2 * left[0] + left[1] + 2) >> 2
        else:
            fl[0] = (3 * left[0] + left[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (left[y - 1] + 2 * left[y] + left[y + 1] + 2) >> 2
        fl[7] = (left[6] + 3 * left[7] + 2) >> 2
    return fl, ft, fc


def _plane_pred(left, top, corner, size: int) -> np.ndarray:
    """Plane prediction (spec 8.3.3.4 for 16x16, 8.3.4.4 for chroma 8x8)."""
    n = size
    half = n // 2
    hsum = sum((x + 1) * (int(top[half + x])
                          - int(corner if half - 2 - x == -1
                                else top[half - 2 - x]))
               for x in range(half))
    vsum = sum((y + 1) * (int(left[half + y])
                          - int(corner if half - 2 - y == -1
                                else left[half - 2 - y]))
               for y in range(half))
    a = 16 * (int(left[n - 1]) + int(top[n - 1]))
    if n == 16:
        b = (5 * hsum + 32) >> 6
        c = (5 * vsum + 32) >> 6
    else:
        b = (17 * hsum + 16) >> 5
        c = (17 * vsum + 16) >> 5
    ys, xs = np.mgrid[0:n, 0:n]
    return clip_pixel((a + b * (xs - (half - 1)) + c * (ys - (half - 1))
                       + 16) >> 5)


def reconstruct_frame(fs: FrameSyntax, sps: SPS, pps: PPS,
                      slice_of_mb: np.ndarray = None):
    """Decode a parsed FrameSyntax into (Y, Cb, Cr) uint8 planes."""
    wmb, hmb = fs.width_mbs, fs.height_mbs
    w, h = wmb * 16, hmb * 16
    luma = PlaneCtx(h, w)
    cb = PlaneCtx(h // 2, w // 2)
    cr = PlaneCtx(h // 2, w // 2)
    if slice_of_mb is None:
        slice_of_mb = np.zeros(fs.n_mbs, dtype=np.int32)

    ls4 = [level_scale_4x4(pps.scaling_list_4x4[i]) for i in range(6)]
    ls8 = [level_scale_8x8(pps.scaling_list_8x8[i]) for i in range(2)]

    for mb in range(fs.n_mbs):
        if not fs.parsed[mb]:
            continue
        _recon_mb(fs, mb, sps, pps, luma, cb, cr, ls4, ls8,
                  int(slice_of_mb[mb]))

    return (luma.plane.astype(np.uint8), cb.plane.astype(np.uint8),
            cr.plane.astype(np.uint8))


def _recon_mb(fs, mb, sps, pps, luma, cbp_, crp_, ls4, ls8, sl):
    wmb = fs.width_mbs
    mx, my = (mb % wmb) * 16, (mb // wmb) * 16
    kind = fs.mb_kind[mb]
    qp = int(fs.qpy[mb])

    if kind == KIND_IPCM:
        luma.plane[my:my + 16, mx:mx + 16] = fs.pcm_y[mb]
        cbp_.plane[my // 2:my // 2 + 8, mx // 2:mx // 2 + 8] = fs.pcm_cb[mb]
        crp_.plane[my // 2:my // 2 + 8, mx // 2:mx // 2 + 8] = fs.pcm_cr[mb]
        luma.mark(mx, my, 16, 16, sl)
        cbp_.mark(mx // 2, my // 2, 8, 8, sl)
        crp_.mark(mx // 2, my // 2, 8, 8, sl)
        return

    if kind == KIND_I4x4:
        for blk in range(16):
            bx, by = int(BLK4x4_POS[blk][0]), int(BLK4x4_POS[blk][1])
            x0, y0 = mx + bx, my + by
            left, top, corner, al, at, ac = _gather_refs(
                luma, x0, y0, 4, 4, sl)
            mode = int(fs.luma4x4_modes[mb, blk])
            pred = _predict_nxn(mode, 4, left, top, corner, al, at, ac)
            d = dequant_4x4(fs.luma_ac[mb, blk], qp, ls4[0])
            res = idct_4x4(d)
            luma.plane[y0:y0 + 4, x0:x0 + 4] = clip_pixel(pred + res)
            luma.mark(x0, y0, 4, 4, sl)
    elif kind == KIND_I8x8:
        for blk8 in range(4):
            bx, by = (blk8 % 2) * 8, (blk8 // 2) * 8
            x0, y0 = mx + bx, my + by
            left, top, corner, al, at, ac = _gather_refs(
                luma, x0, y0, 8, 8, sl)
            fl, ft, fc = _filter_8x8_refs(left, top, corner, al, at, ac)
            mode = int(fs.luma8x8_modes[mb, blk8])
            pred = _predict_nxn(mode, 8, fl, ft, fc, al, at, ac)
            d = dequant_8x8(fs.luma8x8_coeff[mb, blk8], qp, ls8[0])
            res = idct_8x8(d)
            luma.plane[y0:y0 + 8, x0:x0 + 8] = clip_pixel(pred + res)
            luma.mark(x0, y0, 8, 8, sl)
    else:  # I16x16
        left, top, corner, al, at, ac = _gather_refs(luma, mx, my, 16, 0, sl)
        mode = int(fs.i16_mode[mb])
        if mode == 0:
            pred = np.broadcast_to(top[None, :16], (16, 16)).copy()
        elif mode == 1:
            pred = np.broadcast_to(left[:16, None], (16, 16)).copy()
        elif mode == 2:
            if al and at:
                v = (left[:16].sum() + top[:16].sum() + 16) >> 5
            elif al:
                v = (left[:16].sum() + 8) >> 4
            elif at:
                v = (top[:16].sum() + 8) >> 4
            else:
                v = 128
            pred = np.full((16, 16), v, dtype=np.int64)
        else:
            pred = _plane_pred(left, top, corner, 16)
        # residual: DC transform + per-block AC
        dc = luma_dc_transform(fs.luma_dc[mb], qp, ls4[0])
        recon = np.zeros((16, 16), dtype=np.int64)
        for blk in range(16):
            bx, by = int(BLK4x4_POS[blk][0]), int(BLK4x4_POS[blk][1])
            d = dequant_4x4(fs.luma_ac[mb, blk], qp, ls4[0], skip_dc=True)
            d[0, 0] = dc[by // 4, bx // 4]
            res = idct_4x4(d)
            recon[by:by + 4, bx:bx + 4] = res
        luma.plane[my:my + 16, mx:mx + 16] = clip_pixel(pred + recon)
        luma.mark(mx, my, 16, 16, sl)

    # chroma (both components)
    qpc = chroma_qp(qp, pps.chroma_qp_index_offset)
    qpc2 = chroma_qp(qp, pps.second_chroma_qp_index_offset)
    for ic, (ctx, cqp) in enumerate(((cbp_, qpc), (crp_, qpc2))):
        cx, cy = mx // 2, my // 2
        left, top, corner, al, at, ac = _gather_refs(ctx, cx, cy, 8, 0, sl)
        cmode = int(fs.chroma_mode[mb])
        if cmode == 0:
            pred = _chroma_dc_pred(left, top, al, at)
        elif cmode == 1:
            pred = np.broadcast_to(left[:8, None], (8, 8)).copy()
        elif cmode == 2:
            pred = np.broadcast_to(top[None, :8], (8, 8)).copy()
        else:
            pred = _plane_pred(left, top, corner, 8)
        # residual
        ls = ls4[1 + ic]
        dc = chroma_dc_transform(fs.chroma_dc[mb, ic], cqp, ls)
        recon = np.zeros((8, 8), dtype=np.int64)
        for blk in range(4):
            bx, by = (blk % 2) * 4, (blk // 2) * 4
            d = dequant_4x4(fs.chroma_ac[mb, ic, blk], cqp, ls, skip_dc=True)
            d[0, 0] = dc[by // 4, bx // 4]
            recon[by:by + 4, bx:bx + 4] = idct_4x4(d)
        ctx.plane[cy:cy + 8, cx:cx + 8] = clip_pixel(pred + recon)
        ctx.mark(cx, cy, 8, 8, sl)


def _chroma_dc_pred(left, top, al: bool, at: bool) -> np.ndarray:
    """Chroma DC prediction per 4x4 sub-block (spec 8.3.4.1)."""
    pred = np.zeros((8, 8), dtype=np.int64)
    for by in (0, 4):
        for bx in (0, 4):
            t = top[bx:bx + 4]
            l = left[by:by + 4]
            if bx == by:  # (0,0) and (4,4): use both when available
                if al and at:
                    v = (t.sum() + l.sum() + 4) >> 3
                elif at:
                    v = (t.sum() + 2) >> 2
                elif al:
                    v = (l.sum() + 2) >> 2
                else:
                    v = 128
            elif bx > by:  # (4,0): prefer top
                if at:
                    v = (t.sum() + 2) >> 2
                elif al:
                    v = (l.sum() + 2) >> 2
                else:
                    v = 128
            else:  # (0,4): prefer left
                if al:
                    v = (l.sum() + 2) >> 2
                elif at:
                    v = (t.sum() + 2) >> 2
                else:
                    v = 128
            pred[by:by + 4, bx:bx + 4] = v
    return pred

"""Lane-major per-wave intra prediction and reconstruction, plain
PyTorch, and the lane loop.

Port of minivideo_tpu/ops/recon_lane.py.  `wave_compute_lane` is the
plain version of the prediction half of the fused wave kernel
(ops/csrc/wave_kernel.cu); `reconstruct_frames_lane` is the JAX module's
XLA loop as torch ops (raster staging -> build_residuals -> pack_lane
-> a Python loop over the waves -> unskew_planes_lane), and the port's
`wave` engine (ops/recon_wave.reconstruct_frames_wave) runs it too: the
JAX wave loop computes the same per-wave math in another layout, and
the JAX package's tests hold the two loops equal.  Where the JAX
loop vmaps `wave_compute_lane` over the batch, this one folds the batch
into the lanes ([S, B*L]): the lanes are independent, so that is the
same computation, in one call per wave.  Every per-wave tensor is
lane-major, the wave-lane axis last, with the per-MB structure in the
first axis:

    luma tile     [256, L]   row = 16*y + x
    chroma tile   [128, L]   row = comp*64 + 8*y + x
    refs          [ 16, L]
    per-MB scalar [  1, L]

The JAX code predicts with one exact f32 matmul against a selection
matrix per block size (`_SEL4_T` / `_SEL8_T`, kept here for parity
tests); this port applies the same taps as integer gathers, which give
the same integers.

Reference scope: intra prediction modes and reconstruction per
h264_intra_prediction.c / h264_transform.c of the reference decoder.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.h264.syntax import (KIND_I4x4, KIND_I8x8, KIND_I16x16,
                                  KIND_IPCM)
from .recon import PackedFrames, _TR4_CLASS, build_residuals
from .recon_wave import (TAP_ROWS4, TAP_ROWS8, _BLK_X, _BLK_Y, _SEL4, _SEL8,
                         geometry, pack_skewed, unskew_planes)

# ---------------------------------------------------------------------------
# transposed selection matrices (JAX layout): acc[o, l] = sum_s M[s, o] *
# refs[s, l], with each row's rounding constant and shift folded in


def _sel_T(sel):
    M, rnd, shift = sel
    assert M.min() >= 0.0 and shift.max() <= 2
    sc = (1.0 / np.left_shift(1, shift.reshape(-1))).astype(np.float32)
    MT = np.ascontiguousarray(M.T).astype(np.float32) * sc[:, None]
    aug = np.concatenate(
        [MT, (rnd.reshape(-1) * sc)[:, None].astype(np.float32)], axis=1)
    return np.ascontiguousarray(aug)


_SEL4_T = _sel_T(_SEL4)   # [144, 14] f32 (13 refs + 1 bias column)
_SEL8_T = _sel_T(_SEL8)   # [576, 26]


@functools.lru_cache(maxsize=None)
def device_taps(device):
    """{n: (tap rows [9*n*n, 8] int32, their sample indices [9*n*n, 3]
    int64)} on `device`, copied there once."""
    out = {}
    for n, rows in ((4, TAP_ROWS4), (8, TAP_ROWS8)):
        t = torch.as_tensor(rows, device=device)
        out[n] = (t, t[:, 0:3].long())
    return out


def _predict_lane(s, mode, dc, n):
    """s [S, L] int32 samples in [0, 255]; mode/dc [1, L].

    Returns the mode-selected prediction as [n*n, L] (row = n*y + x):
    the 8 directional modes from the tap rows (TAP_ROWS4/8), DC (mode 2)
    from `dc`.
    """
    t, idx = device_taps(s.device)[n]
    acc = ((t[:, 3:6, None] * s[idx]).sum(1, dtype=torch.int32)
           + t[:, 6:7]) >> t[:, 7:8]
    nn = n * n
    out = torch.zeros((nn, s.shape[-1]), dtype=torch.int32, device=s.device)
    for m in range(9):
        val = (dc.expand(nn, -1) if m == 2 else acc[m * nn:(m + 1) * nn])
        out = torch.where(mode == m, val, out)
    return out


def _dc(sum_l, sum_t, al, at, n):
    log2n = n.bit_length() - 1
    return torch.where(
        al & at, (sum_l + sum_t + n) >> (log2n + 1),
        torch.where(al, (sum_l + n // 2) >> log2n,
                    torch.where(at, (sum_t + n // 2) >> log2n,
                                torch.full_like(sum_l, 128))))


def _plane_lane(left, top, corner, n):
    """Plane prediction -> [n*n, L] (spec 8.3.3.4 / 8.3.4.4).
    left/top [n, L], corner [1, L]."""
    half = n // 2
    acc_h = torch.zeros_like(corner)
    acc_v = torch.zeros_like(corner)
    for x in range(half):
        lo_t = corner if half - 2 - x == -1 else top[half - 2 - x:half - 1 - x]
        acc_h = acc_h + (x + 1) * (top[half + x:half + x + 1] - lo_t)
        lo_l = (corner if half - 2 - x == -1
                else left[half - 2 - x:half - 1 - x])
        acc_v = acc_v + (x + 1) * (left[half + x:half + x + 1] - lo_l)
    a = 16 * (left[n - 1:n] + top[n - 1:n])
    if n == 16:
        b = (5 * acc_h + 32) >> 6
        c = (5 * acc_v + 32) >> 6
    else:
        b = (17 * acc_h + 16) >> 5
        c = (17 * acc_v + 16) >> 5
    g = torch.arange(n * n, dtype=torch.int32, device=corner.device)[:, None]
    gx = g % n
    gy = g // n
    val = (a + b * (gx - (half - 1)) + c * (gy - (half - 1)) + 16) >> 5
    return val.clamp(0, 255)


def _filter8_lane(left, top16, corner, al, at, ac):
    """Intra_8x8 reference filtering (spec 8.3.2.2.1), first axis = ref
    index.  left [8, L], top16 [16, L], corner/flags [1, L]."""
    zero = torch.zeros_like(corner)
    t_m1 = torch.where(ac, corner, zero)
    tp = torch.cat([t_m1, top16])
    ft_mid = (tp[:-2] + 2 * tp[1:-1] + tp[2:] + 2) >> 2
    ft0 = torch.where(ac, (corner + 2 * top16[0:1] + top16[1:2] + 2) >> 2,
                      (3 * top16[0:1] + top16[1:2] + 2) >> 2)
    ft15 = (top16[14:15] + 3 * top16[15:16] + 2) >> 2
    ft = torch.cat([ft0, ft_mid[1:], ft15])
    ft = torch.where(at, ft, top16)
    fc = torch.where(at & al,
                     (top16[0:1] + 2 * corner + left[0:1] + 2) >> 2,
                     torch.where(at, (3 * corner + top16[0:1] + 2) >> 2,
                                 torch.where(al, (3 * corner + left[0:1] + 2)
                                             >> 2, corner)))
    fc = torch.where(ac, fc, corner)
    l_m1 = torch.where(ac, corner, zero)
    lp = torch.cat([l_m1, left])
    fl_mid = (lp[:-2] + 2 * lp[1:-1] + lp[2:] + 2) >> 2
    fl0 = torch.where(ac, (corner + 2 * left[0:1] + left[1:2] + 2) >> 2,
                      (3 * left[0:1] + left[1:2] + 2) >> 2)
    fl7 = (left[6:7] + 3 * left[7:8] + 2) >> 2
    fl = torch.cat([fl0, fl_mid[1:], fl7])
    fl = torch.where(al, fl, left)
    return fl, ft, fc


def _rows(t, y0, x0, ny, nx):
    """Tile rows y0..y0+ny, cols x0..x0+nx as [ny*nx, L]."""
    return torch.cat([t[(y0 + y) * 16 + x0:(y0 + y) * 16 + x0 + nx]
                      for y in range(ny)])


def _col(t, x, y0, n):
    """Tile column x, rows y0..y0+n -> [n, L]."""
    return t[(y0 * 16 + x):((y0 + n) * 16 + x):16]


# ---------------------------------------------------------------------------
# the per-wave computation (lane-major: one wave, lanes L)


def wave_compute_lane(left_col, corner, top_row, tr_row, left_c, corner_cb,
                      corner_cr, top_c, kind, al, at, atl, atr, parsed,
                      modes4, modes8, i16_mode, cmode, res_luma, res_chroma,
                      has8x8=True, haspcm=True):
    """One wave, MBs dense over lanes (same contract as the JAX function).

    Shapes: refs [16, L] (left_c/top_c carry Cb in rows 0-7, Cr in
    8-15); corners/flags/scalars [1, L]; modes4 [16, L]; modes8 [4, L];
    res_luma [256, L]; res_chroma [128, L].  al/at/atl/atr are bool
    [1, L].  Returns (tile [256, L], ctile [128, L]) int32 in [0, 255];
    unparsed lanes give zeros.
    """
    L = left_col.shape[-1]
    ones = torch.ones_like(al)
    zeros_b = torch.zeros_like(al)
    zero = torch.zeros((), dtype=torch.int32, device=left_col.device)

    left_col = torch.where(al, left_col, zero)
    corner16 = torch.where(atl, corner, zero)
    top_row_m = torch.where(at, top_row, zero)
    tr_row_m = torch.where(atr, tr_row, zero)
    left_c_m = torch.where(al, left_c, zero)
    top_c_m = torch.where(at, top_c, zero)
    corner_cb_m = torch.where(atl, corner_cb, zero)
    corner_cr_m = torch.where(atl, corner_cr, zero)

    tile = torch.zeros((256, L), dtype=torch.int32, device=left_col.device)

    def t_write(out_flat, bx, by, n, keep):
        for y in range(n):
            r = (by + y) * 16 + bx
            tile[r:r + n] = torch.where(keep, out_flat[y * n:(y + 1) * n],
                                        tile[r:r + n])

    # ---- I4x4: 16 block steps in decoding order ---------------------------
    is4 = kind == KIND_I4x4
    for b in range(16):
        bx, by = _BLK_X[b], _BLK_Y[b]
        if bx == 0:
            l4 = left_col[by:by + 4]
            al_b = al
        else:
            l4 = _col(tile, bx - 1, by, 4)
            al_b = ones
        if by == 0:
            t4 = top_row_m[bx:bx + 4]
            at_b = at
            if bx < 12:
                tr4 = top_row_m[bx + 4:bx + 8]
                tr_b = at
            else:
                tr4 = tr_row_m[0:4]
                tr_b = atr
            if bx == 0:
                c4 = corner16
                ac_b = atl
            else:
                c4 = top_row_m[bx - 1:bx]
                ac_b = at
        else:
            lo = max(bx - 1, 0)
            hi = min(bx + 8, 16)
            trow = _rows(tile, by - 1, lo, 1, hi - lo)
            off = bx - lo
            t4 = trow[off:off + 4]
            at_b = ones
            if _TR4_CLASS[b] == 1:
                tr4 = trow[off + 4:off + 8]
                tr_b = ones
            else:
                tr4 = t4[3:4].expand(4, -1)
                tr_b = zeros_b
            if bx == 0:
                c4 = left_col[by - 1:by]
                ac_b = al
            else:
                c4 = trow[off - 1:off]
                ac_b = ones
        l4 = torch.where(al_b, l4, zero)
        t4 = torch.where(at_b, t4, zero)
        tr4 = torch.where(tr_b, tr4, t4[3:4].expand(4, -1))
        tr4 = torch.where(at_b, tr4, zero)
        c4 = torch.where(ac_b, c4, zero)
        s = torch.cat([c4, t4, tr4, l4])
        dc = _dc(l4.sum(0, keepdim=True, dtype=torch.int32),
                 t4.sum(0, keepdim=True, dtype=torch.int32), al_b, at_b, 4)
        pred = _predict_lane(s, modes4[b:b + 1], dc, 4)
        res = _rows(res_luma, by, bx, 4, 4)
        out = (pred + res).clamp(0, 255)
        t_write(out, bx, by, 4, is4)

    # ---- I8x8: 4 block steps ------------------------------------------------
    is8 = kind == KIND_I8x8
    for b8 in range(4) if has8x8 else ():
        bx, by = (b8 % 2) * 8, (b8 // 2) * 8
        if bx == 0:
            l8 = left_col[by:by + 8]
            al_b = al
        else:
            l8 = _col(tile, bx - 1, by, 8)
            al_b = ones
        if by == 0:
            t8 = top_row_m[bx:bx + 8]
            at_b = at
            if bx == 0:
                tr8 = top_row_m[8:16]
                tr_b = at
                c8 = corner16
                ac_b = atl
            else:
                tr8 = tr_row_m[0:8]
                tr_b = atr
                c8 = top_row_m[bx - 1:bx]
                ac_b = at
        else:
            trow = _rows(tile, by - 1, 0, 1, 16)
            t8 = trow[bx:bx + 8]
            at_b = ones
            if b8 == 2:
                tr8 = trow[8:16]
                tr_b = ones
            else:
                tr8 = t8[7:8].expand(8, -1)
                tr_b = zeros_b
            if bx == 0:
                c8 = left_col[by - 1:by]
                ac_b = al
            else:
                c8 = trow[bx - 1:bx]
                ac_b = ones
        l8 = torch.where(al_b, l8, zero)
        t8 = torch.where(at_b, t8, zero)
        tr8 = torch.where(tr_b, tr8, t8[7:8].expand(8, -1))
        tr8 = torch.where(at_b, tr8, zero)
        c8 = torch.where(ac_b, c8, zero)
        t16 = torch.cat([t8, tr8])
        fl, ft, fc = _filter8_lane(l8, t16, c8, al_b, at_b, ac_b)
        s = torch.cat([fc, ft, fl])
        dc = _dc(fl.sum(0, keepdim=True, dtype=torch.int32),
                 ft[:8].sum(0, keepdim=True, dtype=torch.int32),
                 al_b, at_b, 8)
        pred = _predict_lane(s, modes8[b8:b8 + 1], dc, 8)
        res = _rows(res_luma, by, bx, 8, 8)
        out = (pred + res).clamp(0, 255)
        t_write(out, bx, by, 8, is8)

    # ---- I16x16 / PCM ------------------------------------------------------
    is_pcm = kind == KIND_IPCM
    is16 = (kind == KIND_I16x16) | is_pcm if haspcm else kind == KIND_I16x16
    pred_v = top_row_m.repeat(16, 1)
    pred_h = left_col.repeat_interleave(16, dim=0)
    dc16 = _dc(left_col.sum(0, keepdim=True, dtype=torch.int32),
               top_row_m.sum(0, keepdim=True, dtype=torch.int32), al, at, 16)
    pl16 = _plane_lane(left_col, top_row_m, corner16, 16)
    p16 = torch.where(i16_mode == 0, pred_v,
                      torch.where(i16_mode == 1, pred_h,
                                  torch.where(i16_mode == 2,
                                              dc16.expand(256, -1), pl16)))
    if haspcm:
        p16 = torch.where(is_pcm, zero, p16)
    out16 = (p16 + res_luma).clamp(0, 255)
    tile = torch.where(is16, out16, tile)

    # ---- chroma (per component) -------------------------------------------
    ctiles = []
    for ic, ccorner in ((0, corner_cb_m), (1, corner_cr_m)):
        lc = left_c_m[ic * 8:(ic + 1) * 8]
        tc = top_c_m[ic * 8:(ic + 1) * 8]
        st0 = tc[:4].sum(0, keepdim=True, dtype=torch.int32)
        st1 = tc[4:].sum(0, keepdim=True, dtype=torch.int32)
        sl0 = lc[:4].sum(0, keepdim=True, dtype=torch.int32)
        sl1 = lc[4:].sum(0, keepdim=True, dtype=torch.int32)
        c128 = torch.full_like(st0, 128)

        def dcb(tsum, lsum, prefer):
            both = (tsum + lsum + 4) >> 3
            t_only = (tsum + 2) >> 2
            l_only = (lsum + 2) >> 2
            if prefer == "both":
                return torch.where(al & at, both,
                                   torch.where(at, t_only,
                                               torch.where(al, l_only, c128)))
            if prefer == "top":
                return torch.where(at, t_only,
                                   torch.where(al, l_only, c128))
            return torch.where(al, l_only, torch.where(at, t_only, c128))

        d00 = dcb(st0, sl0, "both")
        d01 = dcb(st1, sl0, "top")
        d10 = dcb(st0, sl1, "left")
        d11 = dcb(st1, sl1, "both")
        row_t = torch.cat([d00.expand(4, -1), d01.expand(4, -1)])   # [8, L]
        row_b = torch.cat([d10.expand(4, -1), d11.expand(4, -1)])
        pred_dc = torch.cat([row_t] * 4 + [row_b] * 4)
        pred_h = lc.repeat_interleave(8, dim=0)
        pred_v = tc.repeat(8, 1)
        pl = _plane_lane(lc, tc, ccorner, 8)
        predc = torch.where(cmode == 0, pred_dc,
                            torch.where(cmode == 1, pred_h,
                                        torch.where(cmode == 2, pred_v, pl)))
        if haspcm:
            predc = torch.where(is_pcm, zero, predc)
        resc = res_chroma[ic * 64:(ic + 1) * 64]
        ctiles.append((predc + resc).clamp(0, 255))
    ctile = torch.cat(ctiles)                        # [128, L]

    pmask = parsed > 0
    return torch.where(pmask, tile, zero), torch.where(pmask, ctile, zero)


# ---------------------------------------------------------------------------
# the lane loop: a Python loop over the waves, the batch in the lanes


def _unpack_meta_t(meta_t):
    """meta_t [B, 32, L] -> per-field views (layout from pack_skewed).
    Scalar fields keep a singleton sublane dim: [B, 1, L]."""
    return {
        "kind": meta_t[:, 0:1],
        "parsed": meta_t[:, 1:2],
        "al": meta_t[:, 2:3] > 0,
        "at": meta_t[:, 3:4] > 0,
        "atl": meta_t[:, 4:5] > 0,
        "atr": meta_t[:, 5:6] > 0,
        "i16_mode": meta_t[:, 6:7],
        "cmode": meta_t[:, 7:8],
        "modes8": meta_t[:, 8:12],
        "modes4": meta_t[:, 12:28],
    }


def pack_lane(arrays, res, g):
    """pack_skewed output, transposed to lane-major wave slabs."""
    B = arrays["mb_kind"].shape[0]
    n_waves, maxw = g["skew_idx"].shape
    sk0 = pack_skewed(arrays, res, g)
    return {
        "meta": sk0["meta"].permute(0, 1, 3, 2).contiguous(),
        "res_luma": sk0["res_luma"].reshape(
            B, n_waves, maxw, 256).permute(0, 1, 3, 2).contiguous(),
        "res_chroma": sk0["res_chroma"].reshape(
            B, n_waves, maxw, 128).permute(0, 1, 3, 2).contiguous(),
    }


def unskew_planes_lane(out_y, out_c, g):
    """out_y [B, W, 256, maxw] uint8, out_c [B, W, 128, maxw] ->
    (Y, Cb, Cr) raster planes via the wave engine's unskew."""
    B = out_y.shape[0]
    n_waves, maxw = g["skew_idx"].shape
    oy = out_y.permute(0, 1, 3, 2).reshape(B, n_waves, maxw, 16, 16)
    oc = out_c.permute(0, 1, 3, 2).reshape(B, n_waves, maxw, 16, 8)
    return unskew_planes(oy, oc, g)


@functools.lru_cache(maxsize=None)
def make_reconstruct_lane(wmb: int, hmb: int, device):
    """The batched lane reconstructor of one MB geometry on `device`:
    recon(arrays, ls4, ls8, cb_off, cr_off) -> (Y, Cb, Cr) uint8 tensors
    [B, H, W] there, for raster staging tensors `arrays` there."""
    g = geometry(wmb, hmb)
    n_waves, maxw = g["n_waves"], g["maxw"]
    i32 = torch.int32

    def wave_body(w, state, sk):
        out_y, out_c, row_y, row_c, bot_y, bot_c = state
        B = row_y.shape[0]
        r0, c0 = int(g["r0"][w]), int(g["c0"][w])
        pc, half, halfr = c0 & 1, c0 >> 1, (c0 + 1) >> 1
        rr0 = hmb - 1 - r0      # row state stored in reversed row order
        rs_y = row_y[:, :, rr0:rr0 + maxw]
        rs_c = row_c[:, :, rr0:rr0 + maxw]
        top_row = bot_y[:, pc, :, half:half + maxw]
        tr_row = bot_y[:, 1 - pc, :, halfr:halfr + maxw]
        top_c = bot_c[:, pc, :, half:half + maxw]
        meta = _unpack_meta_t(sk["meta"][:, w])

        def fold(x):            # [B, S, L] -> [S, B*L]
            return x.transpose(0, 1).reshape(x.shape[1], B * maxw)

        def unfold(x):          # [S, B*L] -> [B, S, L]
            return x.reshape(x.shape[0], B, maxw).transpose(0, 1)

        args = (rs_y[:, :16], rs_y[:, 16:17], top_row, tr_row,
                rs_c[:, :16], rs_c[:, 16:17], rs_c[:, 17:18], top_c,
                meta["kind"], meta["al"], meta["at"], meta["atl"],
                meta["atr"], meta["parsed"], meta["modes4"], meta["modes8"],
                meta["i16_mode"], meta["cmode"], sk["res_luma"][:, w],
                sk["res_chroma"][:, w])
        tile, ctile = map(unfold, wave_compute_lane(*map(fold, args)))

        # every new value is computed before any store: rs_*, top_row and
        # top_c are views of the state
        upd = meta["parsed"] > 0                      # [B, 1, L]
        new_row = torch.where(upd, torch.cat(
            [tile[:, 15::16], top_row[:, 15:16],
             torch.zeros((B, 1, maxw), dtype=i32, device=device)], 1), rs_y)
        new_rowc = torch.where(upd, torch.cat(
            [ctile[:, 7::8], top_c[:, 7:8], top_c[:, 15:16]], 1), rs_c)
        new_bot = torch.where(upd, tile[:, 240:256], top_row)
        new_botc = torch.where(upd, torch.cat(
            [ctile[:, 56:64], ctile[:, 120:128]], 1), top_c)
        out_y[:, w] = tile.to(torch.uint8)
        out_c[:, w] = ctile.to(torch.uint8)
        row_y[:, :, rr0:rr0 + maxw] = new_row
        row_c[:, :, rr0:rr0 + maxw] = new_rowc
        bot_y[:, pc, :, half:half + maxw] = new_bot
        bot_c[:, pc, :, half:half + maxw] = new_botc

    def recon(arrays, ls4, ls8, cb_off, cr_off):
        res = build_residuals(arrays, ls4, ls8, cb_off, cr_off)
        B = arrays["mb_kind"].shape[0]
        sk = pack_lane(arrays, res, g)
        del res

        def zeros(shape, dtype=i32):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = (zeros((B, n_waves, 256, maxw), torch.uint8),
                 zeros((B, n_waves, 128, maxw), torch.uint8),
                 zeros((B, 18, g["ROWP"])), zeros((B, 18, g["ROWP"])),
                 zeros((B, 2, 16, g["BOTP"])), zeros((B, 2, 16, g["BOTP"])))
        for w in range(n_waves):
            wave_body(w, state, sk)
        return unskew_planes_lane(state[0], state[1], g)

    return recon


def _on_device(packed: PackedFrames, device):
    """`packed` (raster staging) with its arrays as tensors on `device`
    (ops/recon_fused.to_device: device=None leaves tensors where they lie
    and puts numpy staging on the GPU, raising where there is none)."""
    from .recon_fused import to_device
    if packed.slots != 0:
        raise ValueError("the wave and lane engines take raster staging "
                         f"(slots=0), not slots={packed.slots}")
    packed = to_device(packed, device)
    return packed, packed.arrays["mb_kind"].device


def reconstruct_frames_lane(packed: PackedFrames, device=None):
    """Decode a raster PackedFrames batch with the lane loop on
    `device` (default: where its staging tensors lie, or the GPU for
    numpy staging).  Returns (Y, Cb, Cr) uint8 tensors [B, H, W] there."""
    packed, dev = _on_device(packed, device)
    fn = make_reconstruct_lane(packed.wmb, packed.hmb, dev)
    return fn(packed.arrays, packed.ls4, packed.ls8, *packed.chroma_qp_off)

"""Slab-layout residual construction (dequant + IDCT + assembly), plain
PyTorch.

Port of minivideo_tpu/ops/slab.py.  `residual_from_slabs` is the plain
version of the residual half of the fused wave kernel
(ops/csrc/wave_kernel.cu): it works on one wave's int32 slabs [S, L],
with the lane axis L = batch * maxw last, exactly as the JAX function
does.  The JAX code assembles pixels and applies the DC Hadamards with
exact f32 0/1 matmuls; here the same maps are integer gathers and
integer sums, which compute the same integers.

Slab layouts (per macroblock; b/blk indices are raster within the MB):

  luma [256]:
    4x4 coeffs   s = 64*j + 16*i + b      b = 4*u + v over the 4x4 grid
    8x8 coeffs   s = 32*j +  4*i + blk    blk in [0,4) raster
    PCM pixels   s = 64*(Y%4) + 16*(X%4) + 4*(Y//4) + (X//4)
  chroma [128]:
    AC coeffs    s = 32*j + 8*i + 4*ic + blk
    PCM pixels   s = 32*(Y%4) + 8*(X%4) + 4*ic + 2*(Y//4) + (X//4)
  dc [32]:
    luma DC      s = 4*u + v              (I16x16 only)
    chroma DC    s = 16 + 4*ic + 2*u + v  (rows 24..31 zero padding)

(i, j) is the coefficient's (row, col) inside its block.  Outputs are
res_luma [256, L] with sublane 16*Y + X and res_chroma [128, L] with
sublane 64*ic + 8*Y + X.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.h264.syntax import KIND_I8x8, KIND_I16x16, KIND_IPCM
from ..models.h264.tables import QPC_FROM_QPI
from .transform import _idct8_stage_t

# ---------------------------------------------------------------------------
# meta row layout ([META_ROWS, L] int32 per wave)

META_ROWS = 40
DC_ROWS = 32
R_KIND, R_PARSED, R_AL, R_AT, R_ATL, R_ATR, R_I16M, R_CMODE = range(8)
R_MODES8 = 8            # rows 8..11
R_MODES4 = 12           # rows 12..27
R_YM6, R_YDIV, R_CBM6, R_CBDIV, R_CRM6, R_CRDIV = range(28, 34)

# ---------------------------------------------------------------------------
# static layout tables (the JAX package's f32 matrices, kept for parity
# tests; the torch code uses the integer gathers derived from them)


def _p4_np():
    P = np.zeros((256, 256), np.float32)
    for u in range(4):
        for v in range(4):
            for y in range(4):
                for x in range(4):
                    P[16 * (4 * u + y) + 4 * v + x,
                      64 * y + 16 * x + 4 * u + v] = 1.0
    return P


def _p8_np():
    P = np.zeros((256, 256), np.float32)
    for blk in range(4):
        for y in range(8):
            for x in range(8):
                P[16 * (8 * (blk // 2) + y) + 8 * (blk % 2) + x,
                  32 * y + 4 * x + blk] = 1.0
    return P


def _pc_np():
    P = np.zeros((128, 128), np.float32)
    for ic in range(2):
        for blk in range(4):
            for y in range(4):
                for x in range(4):
                    P[64 * ic + 8 * (4 * (blk // 2) + y)
                      + 4 * (blk % 2) + x,
                      32 * y + 8 * x + 4 * ic + blk] = 1.0
    return P


P4 = _p4_np()
P8 = _p8_np()
PC = _pc_np()

_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], np.float32)
_H2 = np.array([[1, 1], [1, -1]], np.float32)
HH16 = np.kron(_H4, _H4)                       # [16, 16] luma DC hadamard
_HH4 = np.kron(_H2, _H2)
HH8C = np.zeros((8, 8), np.float32)            # block-diag per component
HH8C[:4, :4] = _HH4
HH8C[4:, 4:] = _HH4

# each permutation row's single source sublane: res[r] = x[PERM[r]]
PERM4 = np.argmax(P4, axis=1).astype(np.int64)
PERM8 = np.argmax(P8, axis=1).astype(np.int64)
PERMC = np.argmax(PC, axis=1).astype(np.int64)

# coefficient (row, col) per slab sublane, for the scale tables
_S = np.arange(256)
_I4S, _J4S = (_S // 16) % 4, _S // 64
_I8S, _J8S = (_S // 4) % 8, _S // 32
_SC = np.arange(128)
_IC_I, _IC_J = (_SC // 8) % 4, _SC // 32


def scale_tables(ls4, ls8):
    """LevelScale tables in slab order: T4/T8 [256, 6], TCb/TCr [128, 6]
    int32 numpy arrays.  ls4 [3, 6, 4, 4] (luma/Cb/Cr), ls8 [6, 8, 8]."""
    ls4 = np.asarray(ls4)
    ls8 = np.asarray(ls8)
    t4 = ls4[0][:, _I4S, _J4S].T.astype(np.int32)
    t8 = ls8[:, _I8S, _J8S].T.astype(np.int32)
    tcb = ls4[1][:, _IC_I, _IC_J].T.astype(np.int32)
    tcr = ls4[2][:, _IC_I, _IC_J].T.astype(np.int32)
    return t4, t8, tcb, tcr


# ---------------------------------------------------------------------------
# the residual body on [S, L] int32 tensors


def _perm(x, perm):
    return x[torch.as_tensor(perm, device=x.device)]


def _hadamard(H, x):
    """Integer product of a +-1 matrix H [n, n] (numpy) with x [n, L]."""
    Ht = torch.as_tensor(H.astype(np.int32), device=x.device)
    return (Ht[:, :, None] * x[None]).sum(1, dtype=torch.int32)


def _sel_scale(T, m6):
    """T [S, 6] int32, m6 [1, L] -> per-lane scale [S, L]."""
    out = torch.zeros((T.shape[0], m6.shape[-1]), dtype=torch.int32,
                      device=m6.device)
    for m in range(6):
        out = torch.where(m6 == m, T[:, m:m + 1], out)
    return out


def _idct4_slab(d, gw):
    """4x4 IDCT on a slab whose sublanes are s = 4*gw*j + gw*i + q with
    q in [0, gw).  Returns rows s = 4*gw*y + gw*x + q (spec 8.5.12.2)."""
    c = [d[4 * gw * j:4 * gw * (j + 1)] for j in range(4)]
    e0 = c[0] + c[2]
    e1 = c[0] - c[2]
    e2 = (c[1] >> 1) - c[3]
    e3 = c[1] + (c[3] >> 1)
    fx = (e0 + e3, e1 + e2, e1 - e2, e0 - e3)        # rows gw*i + q
    g = [torch.cat([fx[x][gw * i:gw * (i + 1)] for x in range(4)])
         for i in range(4)]                          # rows gw*x + q
    h0 = g[0] + g[2]
    h1 = g[0] - g[2]
    h2 = (g[1] >> 1) - g[3]
    h3 = g[1] + (g[3] >> 1)
    out = torch.cat([h0 + h3, h1 + h2, h1 - h2, h0 - h3])
    return (out + 32) >> 6


def _dequant(v, div, qbits):
    """v << (div - qbits) when div >= qbits, else rounded >> (qbits - div)
    (spec 8.5.12.1 with qbits 4, 8.5.13.1 / 8.5.10 with qbits 6)."""
    zero = torch.zeros_like(div)
    rnd = (1 << (qbits - 1)) >> torch.minimum(div, zero + qbits - 1)
    return torch.where(div >= qbits, v << torch.maximum(div - qbits, zero),
                       (v + rnd) >> torch.maximum(qbits - div, zero))


def residual_from_slabs(coefL, coefC, dcs, meta, t4, t8, tcb, tcr,
                        has8x8=True, haspcm=True):
    """Dequant + IDCT + pixel assembly on one wave's slabs.

    coefL [256, L] / coefC [128, L] / dcs [>=24, L] int32; meta
    [META_ROWS, L] int32; t4/t8/tcb/tcr int32 tensors from scale_tables.
    Returns (res_luma [256, L], res_chroma [128, L]) int32, equal to the
    JAX function's.  has8x8 / haspcm drop the 8x8 and PCM paths as the
    JAX kernel's static flags do.
    """
    kind = meta[R_KIND:R_KIND + 1]
    is8 = kind == KIND_I8x8
    is16 = kind == KIND_I16x16
    ispcm = kind == KIND_IPCM
    ym6 = meta[R_YM6:R_YM6 + 1]
    ydiv = meta[R_YDIV:R_YDIV + 1]
    cbm6 = meta[R_CBM6:R_CBM6 + 1]
    cbdiv = meta[R_CBDIV:R_CBDIV + 1]
    crm6 = meta[R_CRM6:R_CRM6 + 1]
    crdiv = meta[R_CRDIV:R_CRDIV + 1]

    # ---- luma 4x4 interpretation (I4x4 + I16x16 AC) -----------------------
    sc4 = _sel_scale(t4, ym6)
    d4 = _dequant(coefL * sc4, ydiv, 4)
    # I16x16 DC: 4x4 hadamard + DC dequant replaces the (0,0) positions
    fdc = _hadamard(HH16, dcs[0:16])
    dcd = _dequant(fdc * sc4[0:16], ydiv, 6)
    d4 = torch.cat([torch.where(is16, dcd, d4[0:16]), d4[16:]])
    out4 = _idct4_slab(d4, 16)                        # rows 64y + 16x + b

    # ---- luma 8x8 interpretation ------------------------------------------
    if has8x8:
        d8 = _dequant(coefL * _sel_scale(t8, ym6), ydiv, 6)
        cj = [d8[32 * j:32 * (j + 1)] for j in range(8)]  # rows 4i + blk
        fx8 = _idct8_stage_t(cj)
        g8 = [torch.cat([fx8[x][4 * i:4 * (i + 1)] for x in range(8)])
              for i in range(8)]                          # rows 4x + blk
        out8 = (torch.cat(_idct8_stage_t(g8)) + 32) >> 6

    # ---- luma assembly -----------------------------------------------------
    resl4 = _perm(torch.where(ispcm, coefL, out4) if haspcm else out4,
                  PERM4)
    if has8x8:
        res_luma = torch.where(is8, _perm(out8, PERM8), resl4)
    else:
        res_luma = resl4

    # ---- chroma ------------------------------------------------------------
    icm = (torch.arange(128, device=coefC.device)[:, None] >> 2) & 1
    scc = torch.where(icm == 1, _sel_scale(tcr, crm6),
                      _sel_scale(tcb, cbm6))
    divc = torch.where(icm == 1, crdiv, cbdiv)
    dC = _dequant(coefC * scc, divc, 4)
    # chroma DC: 2x2 hadamard per component, always substituted (8.5.11)
    fdcc = _hadamard(HH8C, dcs[16:24])
    dcdc = ((fdcc * scc[0:8]) << divc[0:8]) >> 5
    dC = torch.cat([dcdc, dC[8:]])
    outc = _idct4_slab(dC, 8)                         # rows 32y + 8x + q
    res_chroma = _perm(torch.where(ispcm, coefC, outc) if haspcm else outc,
                       PERMC)
    return res_luma, res_chroma


# ---------------------------------------------------------------------------
# feeds: raster and slot-record staging -> the device layout [B, W, S, maxw]
#
# The JAX package builds these feeds as [W, S, B*maxw]; here each function
# emits [B, W, S, maxw], the layout csrc/wave_kernel.cu and
# recon_fused.reconstruct_plain read, and x.permute(1, 2, 0, 3).reshape(
# W, S, B*maxw) of its output is the JAX function's.  They are torch ops
# on the device of their inputs.


def meta_raster(arrays, cb_off, cr_off, wmb, hmb):
    """[META_ROWS, B, n] int32 raster-order meta (availability flags per
    h264_spatial.c:333-428 semantics + per-MB QP % 6 / QP // 6 rows)."""
    kind = arrays["mb_kind"]
    B, n = kind.shape
    dev = kind.device
    parsed = arrays["parsed"] > 0
    sid = arrays["slice_id"]
    qp = arrays["qpy"]
    mm = torch.arange(n, device=dev)
    r = mm // wmb
    c = mm % wmb

    def ok(dm, cond):
        mmc = (mm + dm).clamp(0, n - 1)
        return (cond[None] & parsed[:, mmc]
                & (sid[:, mmc] == sid)).to(torch.int32)

    al = ok(-1, c > 0)
    at = ok(-wmb, r > 0)
    atl = ok(-wmb - 1, (c > 0) & (r > 0))
    atr = ok(-wmb + 1, (c < wmb - 1) & (r > 0))
    qpc_tab = torch.as_tensor(QPC_FROM_QPI, device=dev)
    qpcb = qpc_tab[(qp + cb_off).clamp(0, 51)]
    qpcr = qpc_tab[(qp + cr_off).clamp(0, 51)]
    return torch.cat([
        kind[None], parsed.to(torch.int32)[None],
        al[None], at[None], atl[None], atr[None],
        arrays["i16_mode"][None], arrays["chroma_mode"][None],
        arrays["luma8x8_modes"].permute(2, 0, 1),
        arrays["luma4x4_modes"].permute(2, 0, 1),
        (qp % 6)[None], (qp // 6)[None],
        (qpcb % 6)[None], (qpcb // 6)[None],
        (qpcr % 6)[None], (qpcr // 6)[None],
        torch.zeros((META_ROWS - 34, B, n), dtype=torch.int32, device=dev),
    ])


def slabs_from_raster(arrays):
    """Raster-order PackedFrames coefficient arrays -> slab records
    [B, n, 256] / [B, n, 128] / [B, n, DC_ROWS] int32 (the feed of the
    Python parsers and the native raster parse)."""
    kind = arrays["mb_kind"]
    B, n = kind.shape
    is8 = (kind == KIND_I8x8)[..., None]
    ispcm = (kind == KIND_IPCM)[..., None]

    lac = arrays["luma_ac"].to(torch.int32)
    # decode-order block b = (y8, x8, y4, x4); slab s = 64j + 16i + 4u+v
    s4 = lac.reshape(B, n, 2, 2, 2, 2, 4, 4).permute(
        0, 1, 7, 6, 2, 4, 3, 5).reshape(B, n, 256)
    l8 = arrays["luma8x8_coeff"].to(torch.int32)
    s8 = l8.reshape(B, n, 4, 8, 8).permute(0, 1, 4, 3, 2).reshape(
        B, n, 256)
    pcm = lac.reshape(B, n, 4, 4, 4, 4).permute(
        0, 1, 3, 5, 2, 4).reshape(B, n, 256)
    luma = torch.where(is8, s8, torch.where(ispcm, pcm, s4))

    cac = arrays["chroma_ac"].to(torch.int32)
    sc = cac.reshape(B, n, 2, 2, 2, 4, 4).permute(
        0, 1, 6, 5, 2, 3, 4).reshape(B, n, 128)
    pcmc = cac.reshape(B, n, 2, 2, 4, 2, 4).permute(
        0, 1, 4, 6, 2, 3, 5).reshape(B, n, 128)
    chroma = torch.where(ispcm, pcmc, sc)

    dcs = torch.cat(
        [arrays["luma_dc"].to(torch.int32).reshape(B, n, 16),
         arrays["chroma_dc"].to(torch.int32).reshape(B, n, 8),
         torch.zeros((B, n, DC_ROWS - 24), dtype=torch.int32,
                     device=kind.device)], dim=-1)
    return luma, chroma, dcs


def skew_feed(x_sbn, g, batch):
    """[S, B, n] raster -> [B, W, S, maxw] by the skew gather (padded
    lanes alias MB 0; vmask_feed gates them)."""
    n_waves, maxw = g["skew_idx"].shape
    S = x_sbn.shape[0]
    flat = torch.as_tensor(g["skew_idx"].reshape(-1).astype(np.int64),
                           device=x_sbn.device)
    xs = x_sbn[:, :, flat]
    return xs.reshape(S, batch, n_waves, maxw).permute(
        1, 2, 0, 3).contiguous()


def skew_feed_slab(slab_bns, g, batch):
    """[B, n, S] raster slab records -> [B, W, S, maxw]."""
    return skew_feed(slab_bns.permute(2, 0, 1), g, batch)


def slot_feed(slab_bws, g, batch, dtype=torch.int32):
    """[B, n_waves*maxw, S] slot-ordered records -> [B, W, S, maxw]: the
    native parser writes MB (r, c) at slot w*maxw + k, so this is one
    dense transpose (no gather)."""
    n_waves, maxw = g["skew_idx"].shape
    S = slab_bws.shape[-1]
    x = slab_bws.reshape(batch, n_waves, maxw, S).permute(0, 1, 3, 2)
    return x.to(dtype).contiguous()


def vmask_feed(meta_s, g, batch):
    """Gate the parsed row of skewed meta [B, W, META_ROWS, maxw] on skew
    validity (padded lanes alias MB 0 in the gather)."""
    valid = torch.as_tensor(g["skew_valid"].astype(np.int32),
                            device=meta_s.device)
    out = meta_s.clone()
    out[:, :, R_PARSED] = meta_s[:, :, R_PARSED] * valid
    return out

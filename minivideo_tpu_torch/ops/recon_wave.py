"""Skewed-wavefront intra reconstruction: the geometry, and the `wave`
engine's entry point.

Port of minivideo_tpu/ops/recon_wave.py.  Macroblocks live in "skewed"
space: wave w = 2*row + col, lane k ordered by ascending col; each wave's
MBs form one contiguous row of a [n_waves, maxw, ...] buffer, and
inter-MB dependencies flow through small boundary-state buffers (right
columns / bottom rows / corners).  `skew_tables` is the geometry that
every engine of the port shares (the fused kernel's wave schedule
included); `pack_skewed` / `unskew_planes` move a batch into and out of
that layout.

The `wave` engine (`reconstruct_frames_wave`) runs the lane loop of
ops/recon_lane.py: the same per-wave math as the JAX module's wave loop
(the JAX package holds the two loops equal), on lane-major slabs, as
torch ops on the staging tensors' device.  It is the CPU engine and the
sharding reference, not the production path (that is the fused kernel,
ops/recon_fused.py).

The JAX module predicts with a selection-matrix matmul (int8 or exact
f32 on the MXU); the port applies the same taps (`TAP_ROWS4` /
`TAP_ROWS8`) as integer gathers and weighted sums, so no matmul
precision setting can change a picture.  `_SEL4` / `_SEL8` stay for the
parity test of the taps.

Residual layout made here (see pack_skewed): luma residuals are
pre-assembled into the 16x16 MB plane for every MB kind (PCM raw pixels
included); chroma residuals are [16, 8] with Cb rows 0-7 and Cr rows 8-15.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.h264.syntax import KIND_I4x4, KIND_I8x8
from ..models.h264.tables import BLK4x4_POS
from .predtables import PRED4, PRED8
from .recon import PackedFrames, _assemble_16x16, _assemble_from_8x8

# ---------------------------------------------------------------------------
# geometry


def skew_tables(wmb: int, hmb: int):
    """Lane layout: wave w, lane k -> (r, c) = (r0 - k, c0 + 2k)."""
    n_waves = 2 * (hmb - 1) + wmb
    maxw = min(hmb, (wmb + 1) // 2 + 1)
    r0 = np.minimum(np.arange(n_waves) // 2, hmb - 1)
    c0 = np.arange(n_waves) - 2 * r0
    skew_idx = np.zeros((n_waves, maxw), dtype=np.int32)
    skew_valid = np.zeros((n_waves, maxw), dtype=bool)
    for w in range(n_waves):
        for k in range(maxw):
            r = r0[w] - k
            c = c0[w] + 2 * k
            if 0 <= r < hmb and 0 <= c < wmb:
                skew_idx[w, k] = r * wmb + c
                skew_valid[w, k] = True
    w_of = np.zeros(wmb * hmb, dtype=np.int32)
    k_of = np.zeros(wmb * hmb, dtype=np.int32)
    for r in range(hmb):
        for c in range(wmb):
            w = 2 * r + c
            w_of[r * wmb + c] = w
            k_of[r * wmb + c] = r0[w] - r
    return {"n_waves": n_waves, "maxw": maxw,
            "r0": r0.astype(np.int32), "c0": c0.astype(np.int32),
            "skew_idx": skew_idx, "skew_valid": skew_valid,
            "w_of": w_of, "k_of": k_of}


# prediction selection matrices: refs layout s = [corner, top(2n), left(n)]

def _selection_matrix(tables, n):
    idx, w, rnd, shift = tables
    S = 1 + 2 * n + n
    M = np.zeros((S, 9 * n * n), dtype=np.float32)
    for m in range(9):
        for y in range(n):
            for x in range(n):
                col = (m * n + y) * n + x
                for t in range(3):
                    M[idx[m, y, x, t], col] += w[m, y, x, t]
    return (M, rnd.reshape(9 * n * n).astype(np.int32),
            shift.reshape(9 * n * n).astype(np.int32))


_SEL4 = _selection_matrix(PRED4, 4)
_SEL8 = _selection_matrix(PRED8, 8)


def _tap_rows(tables, n):
    """Tap tables as rows (idx0..2, w0..2, rnd, shift): [9*n*n, 8] int32,
    row (m*n + y)*n + x; the CUDA kernel reads the same rows."""
    idx, w, rnd, shift = tables
    nn = 9 * n * n
    return np.concatenate([idx.reshape(nn, 3), w.reshape(nn, 3),
                           rnd.reshape(nn, 1), shift.reshape(nn, 1)],
                          axis=1).astype(np.int32)


TAP_ROWS4 = _tap_rows(PRED4, 4)
TAP_ROWS8 = _tap_rows(PRED8, 8)

_BLK_X = [int(BLK4x4_POS[b][0]) for b in range(16)]
_BLK_Y = [int(BLK4x4_POS[b][1]) for b in range(16)]


# ---------------------------------------------------------------------------
# packing (the lane loop's layout)


def pack_skewed(arrays, res, g):
    """Per-frame arrays + residuals (tensors on one device) -> skewed
    wave-major layout.

    Returns dict with:
      meta [B, n_waves, maxw, 32] int32,
      res_luma [B, n_waves, maxw, 16, 16] int32 (assembled, all kinds),
      res_chroma [B, n_waves, maxw, 16, 8] int32 (Cb rows 0-7, Cr 8-15).
    """
    wmb = g["wmb"]
    nmb = wmb * g["hmb"]
    n_waves, maxw = g["skew_idx"].shape
    kind = arrays["mb_kind"]
    dev = kind.device
    B = kind.shape[0]
    flat = torch.as_tensor(g["skew_idx"].reshape(-1), device=dev).long()

    a4 = _assemble_16x16(res["r4"])                  # [B, n, 16, 16]
    a8 = _assemble_from_8x8(res["r8"])
    is4 = (kind == KIND_I4x4)[..., None, None]
    is8 = (kind == KIND_I8x8)[..., None, None]
    res_luma = torch.where(is4, a4, torch.where(is8, a8, res["luma16_res"]))
    res_chroma = res["chroma_res"].reshape(B, nmb, 16, 8)

    parsed = arrays["parsed"] > 0
    sid = arrays["slice_id"]
    m = flat
    r = torch.div(m, wmb, rounding_mode="floor")
    c = m - r * wmb

    def ok(mm, cond):
        mmc = mm.clamp(0, nmb - 1)
        return (cond[None, :] & parsed[:, mmc]
                & (sid[:, mmc] == sid[:, m])).to(torch.int32)

    al = ok(m - 1, c > 0)
    at = ok(m - wmb, r > 0)
    atl = ok(m - wmb - 1, (c > 0) & (r > 0))
    atr = ok(m - wmb + 1, (c < wmb - 1) & (r > 0))

    valid = torch.as_tensor(g["skew_valid"].reshape(-1).astype(np.int32),
                            device=dev)
    i32 = torch.int32
    meta = torch.cat([
        kind[:, flat, None].to(i32),
        parsed[:, flat, None].to(i32) * valid[None, :, None],
        al[..., None], at[..., None], atl[..., None], atr[..., None],
        arrays["i16_mode"][:, flat, None].to(i32),
        arrays["chroma_mode"][:, flat, None].to(i32),
        arrays["luma8x8_modes"][:, flat].to(i32),
        arrays["luma4x4_modes"][:, flat].to(i32),
        torch.zeros((B, n_waves * maxw, 4), dtype=i32, device=dev),
    ], -1)
    return {
        "meta": meta.reshape(B, n_waves, maxw, 32),
        "res_luma": res_luma[:, flat].reshape(B, n_waves, maxw, 16, 16),
        "res_chroma": res_chroma[:, flat].reshape(B, n_waves, maxw, 16, 8),
    }


def unskew_planes(out_y, out_c, g):
    """out_y [B, n_waves, maxw, 16, 16] uint8, out_c [..., 16, 8] ->
    (Y, Cb, Cr) raster planes."""
    wmb, hmb = g["wmb"], g["hmb"]
    H, W = hmb * 16, wmb * 16
    n_waves, maxw = g["skew_idx"].shape
    B = out_y.shape[0]
    unskew = torch.as_tensor(g["w_of"].astype(np.int64) * maxw + g["k_of"],
                             device=out_y.device)
    oy = out_y.reshape(B, n_waves * maxw, 16, 16)[:, unskew]
    Y = oy.reshape(B, hmb, wmb, 16, 16).permute(0, 1, 3, 2, 4).reshape(
        B, H, W)
    oc = out_c.reshape(B, n_waves * maxw, 2, 8, 8)[:, unskew]
    C = oc.reshape(B, hmb, wmb, 2, 8, 8).permute(
        0, 3, 1, 4, 2, 5).reshape(B, 2, H // 2, W // 2)
    return Y, C[:, 0], C[:, 1]


def geometry(wmb: int, hmb: int):
    """skew_tables with the MB grid and the boundary-state sizes."""
    g = skew_tables(wmb, hmb)
    g["wmb"], g["hmb"] = wmb, hmb
    g["ROWP"] = hmb + g["maxw"]                   # row state, reversed rows
    g["BOTP"] = (wmb + 1) // 2 + g["maxw"] + 1    # bottom rows per parity
    return g


def reconstruct_frames_wave(packed: PackedFrames, device=None):
    """Decode a raster PackedFrames batch with the wave engine on `device`
    (default: where its staging tensors lie, or the GPU for numpy
    staging): the lane loop.  Returns (Y, Cb, Cr) uint8 tensors [B, H, W]
    there."""
    from .recon_lane import reconstruct_frames_lane
    return reconstruct_frames_lane(packed, device)

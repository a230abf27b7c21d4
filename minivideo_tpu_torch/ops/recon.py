"""Frame packing (staging buffers and PackedFrames) and the batched
residual construction.

Port of minivideo_tpu/ops/recon.py.  Packing comes in three staging
layouts (`PackedFrames.slots`):

  0 raster  - `pack_frames` stacks full FrameSyntax arrays (the Python
              parsers' or the native raster parse's), I_PCM samples in the
              coefficient buffers; `make_frame_staging` / `syntax_into` /
              `pack_frames_staged` are its zero-copy form, where the
              native parser writes the coefficients straight into
              preallocated batch buffers;
  1 records - `make_slab_staging` holds int16 slab records in skew-slot
              order that the native parser writes; `pack_frames_slots`
              stacks the per-MB metadata beside them;
  2 device  - `make_slab_staging2` holds one MB-major int16 record per
              macroblock [B, n, REC_LEN] (coefficients and meta rows,
              native.REC_*), each written whole by the native parser;
              `zero_uncovered` zeroes those that no slice wrote and
              `pack_frames_slots2` wraps them.  On the device
              ops/wave_layout.py lays them out into the kernel's
              per-wave feeds [B, W, S, maxw].

ops/slab.py turns layouts 0 and 1 into those feeds on the device for the
fused engine.  `build_residuals` (torch ops on the staging tensors'
device) dequantises and inverse-transforms every block of a raster batch
in one pass, for the wave and lane loops (ops/recon_wave.py,
ops/recon_lane.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..models.h264.spatial import _blk4x4_at
from ..models.h264.syntax import KIND_I16x16, KIND_IPCM, FrameSyntax
from ..models.h264.tables import BLK4x4_POS, QPC_FROM_QPI
from ..native import REC_LEN, REC_META
from .slab import R_KIND
from .transform import (chroma_dc_transform, dequant_4x4_t, dequant_8x8_t,
                        from_comp_first, idct_4x4_t, idct_8x8_t,
                        level_scale_4x4_np, level_scale_8x8_np,
                        luma_dc_transform, to_comp_first)


def wave_tables(wmb: int, hmb: int):
    """Anti-diagonal schedule: MBs with equal w = 2*row + col are
    dependency-free (deps: left w-1, top w-2, top-right w-1)."""
    n_waves = 2 * (hmb - 1) + wmb
    waves = [[] for _ in range(n_waves)]
    for r in range(hmb):
        for c in range(wmb):
            waves[2 * r + c].append(r * wmb + c)
    maxw = max(len(wv) for wv in waves)
    idx = np.zeros((n_waves, maxw), dtype=np.int32)
    valid = np.zeros((n_waves, maxw), dtype=bool)
    for i, wv in enumerate(waves):
        idx[i, :len(wv)] = wv
        valid[i, :len(wv)] = True
    return idx, valid


# top-right availability class per 4x4 block (spec 8.3.1.2 neighbour
# derivation): 0=false, 1=true (inside the MB), 2=above MB, 3=above-right MB
_TR4_CLASS = np.zeros(16, dtype=np.int32)
for _b in range(16):
    _bx, _by = int(BLK4x4_POS[_b][0]), int(BLK4x4_POS[_b][1])
    if _by == 0:
        _TR4_CLASS[_b] = 3 if _bx == 12 else 2
    elif _bx == 12:
        _TR4_CLASS[_b] = 0
    else:
        _TR4_CLASS[_b] = 1 if _blk4x4_at(_bx + 4, _by - 4) < _b else 0


@dataclass
class PackedFrames:
    """Batch of parsed frames sharing one MB-grid geometry.

    slots=0: `arrays` holds raster-order per-MB arrays and coefficient
    buffers (luma_ac/luma8x8_coeff/chroma_ac/luma_dc/chroma_dc).
    slots=1: the coefficient buffers are replaced by skew-slot-ordered
    int16 slab records (luma_slab/chroma_slab/dc_slab [B, W*maxw, S]).
    slots=2: `records` [B, n, REC_LEN] int16, the MB-major records the
    native parser writes (native.REC_*); or, laid out from them (or
    carried across from the JAX package, whose device layout they are),
    the kernel's feeds meta_slab [B, W, META_ROWS, maxw] int32 and
    luma/chroma/dc slabs [B, W, 256|128|32, maxw] int16
    (recon_fused.DEVICE_STAGING).  Arrays are numpy arrays or torch
    tensors."""
    wmb: int
    hmb: int
    arrays: dict          # name -> array, leading dim = batch
    ls4: np.ndarray       # [3, 6, 4, 4] luma/Cb/Cr intra LevelScale
    ls8: np.ndarray       # [6, 8, 8]
    chroma_qp_off: tuple  # (cb_offset, cr_offset)
    slots: int = 0        # 0 raster, 1 slot records, 2 device layout
    has8x8: bool = True   # PPS transform_8x8_mode_flag (static per stream)

    @property
    def batch(self) -> int:
        if self.slots == 2:
            return next(iter(self.arrays.values())).shape[0]
        return self.arrays["mb_kind"].shape[0]

    @cached_property
    def haspcm(self) -> bool:
        """True if any MB in the batch is I_PCM (scanned once per pack)."""
        if self.slots == 2 and "records" in self.arrays:
            kinds = self.arrays["records"][:, :, REC_META + R_KIND]
        elif self.slots == 2:
            kinds = self.arrays["meta_slab"][:, :, R_KIND]
        else:
            kinds = self.arrays["mb_kind"]
        return bool((kinds == KIND_IPCM).any())


def _scales(pps):
    ls4 = np.stack([level_scale_4x4_np(pps.scaling_list_4x4[i])
                    for i in range(3)])
    return ls4, level_scale_8x8_np(pps.scaling_list_8x8[0])


def _pack(wmb, hmb, arrays, pps, slots):
    return PackedFrames(wmb, hmb, arrays, *_scales(pps),
                        (pps.chroma_qp_index_offset,
                         pps.second_chroma_qp_index_offset), slots=slots,
                        has8x8=bool(pps.transform_8x8_mode_flag))


def _small_arrays(frames) -> dict:
    """The per-MB metadata of `frames` [(FrameSyntax, slice_of_mb)],
    stacked as int32 [B, n(, k)]."""
    n = frames[0][0].n_mbs

    def stack(get):
        return np.stack([np.asarray(get(fs, som), np.int32)
                         for fs, som in frames])

    return {
        "mb_kind": stack(lambda fs, s: fs.mb_kind),
        "qpy": stack(lambda fs, s: fs.qpy),
        "i16_mode": stack(lambda fs, s: fs.i16_mode),
        "chroma_mode": stack(lambda fs, s: fs.chroma_mode),
        "luma4x4_modes": stack(lambda fs, s: fs.luma4x4_modes),
        "luma8x8_modes": stack(lambda fs, s: fs.luma8x8_modes),
        "parsed": stack(lambda fs, s: fs.parsed),
        "slice_id": stack(
            lambda fs, s: s if s is not None else np.zeros(n, np.int32)),
    }


def pack_frames(frames, sps, pps) -> PackedFrames:
    """Raster PackedFrames of frames [(FrameSyntax, slice_of_mb)] parsed
    with full coefficient buffers, for one SPS/PPS."""
    arrays = _small_arrays(frames)

    def stack(get):
        return np.stack([get(fs) for fs, _ in frames])

    arrays.update({
        "luma_dc": stack(lambda fs: fs.luma_dc.astype(np.int32)),
        "luma8x8_coeff": stack(lambda fs: fs.luma8x8_coeff.astype(np.int32)),
        "chroma_dc": stack(lambda fs: fs.chroma_dc.astype(np.int32)),
        "chroma_ac": stack(_chroma_ac_with_pcm),
        "luma_ac": stack(_luma_ac_with_pcm),
    })
    fs0 = frames[0][0]
    return _pack(fs0.width_mbs, fs0.height_mbs, arrays, pps, 0)


def make_frame_staging(wmb: int, hmb: int, batch: int) -> dict:
    """Preallocated batched coefficient buffers the native entropy parser
    writes into directly (via syntax_into), so packing a batch never
    copies the large arrays.  np.zeros maps lazy zero pages, so the
    parser's sparse coefficient writes are the only memory traffic."""
    n = wmb * hmb
    B = batch
    return {
        "luma_dc": np.zeros((B, n, 4, 4), np.int32),
        "luma_ac": np.zeros((B, n, 16, 4, 4), np.int32),
        "luma8x8_coeff": np.zeros((B, n, 4, 8, 8), np.int32),
        "chroma_dc": np.zeros((B, n, 2, 2, 2), np.int32),
        "chroma_ac": np.zeros((B, n, 2, 4, 4, 4), np.int32),
    }


_STAGED = ("luma_dc", "luma_ac", "luma8x8_coeff", "chroma_dc", "chroma_ac")


def syntax_into(staging: dict, i: int, wmb: int, hmb: int) -> FrameSyntax:
    """A FrameSyntax whose large coefficient buffers alias staging[i]."""
    fs = FrameSyntax(wmb, hmb)
    for name in _STAGED:
        view = staging[name][i]
        assert view.flags["C_CONTIGUOUS"]
        setattr(fs, name, view)
    return fs


def pack_frames_staged(staging: dict, frames, sps, pps) -> PackedFrames:
    """pack_frames for frames parsed via syntax_into: the coefficient
    arrays are the staging buffers themselves (zero copies); only the
    small per-MB metadata arrays are stacked."""
    for fs, _ in frames:
        assert not fs.pcm_y, "PCM frames need the copying pack_frames path"
    arrays = _small_arrays(frames)
    B = len(frames)
    for name in _STAGED:
        arrays[name] = staging[name][:B]
    fs0 = frames[0][0]
    return _pack(fs0.width_mbs, fs0.height_mbs, arrays, pps, 0)


def _luma_ac_with_pcm(fs: FrameSyntax) -> np.ndarray:
    """PCM raw luma rides in the (otherwise unused) coefficient buffer."""
    a = fs.luma_ac.astype(np.int32).copy()
    if fs.pcm_y:
        flat = a.reshape(a.shape[0], 16, 16)
        for mb, pix in fs.pcm_y.items():
            flat[mb] = pix
    return a


def _chroma_ac_with_pcm(fs: FrameSyntax) -> np.ndarray:
    a = fs.chroma_ac.astype(np.int32).copy()
    if fs.pcm_cb:
        flat = a.reshape(a.shape[0], 2, 8, 8)
        for mb, pix in fs.pcm_cb.items():
            flat[mb, 0] = pix
        for mb, pix in fs.pcm_cr.items():
            flat[mb, 1] = pix
    return a


def make_slab_staging(wmb: int, hmb: int, batch: int) -> dict:
    """Slot-ordered int16 slab staging for the native parser's records
    mode: one record per skew slot w*maxw + k.  np.zeros maps lazy zero
    pages, so padding slots cost no memory traffic."""
    from .recon_wave import skew_tables
    g = skew_tables(wmb, hmb)
    n_slots = g["n_waves"] * g["maxw"]
    B = batch
    return {
        "luma_slab": np.zeros((B, n_slots, 256), np.int16),
        "chroma_slab": np.zeros((B, n_slots, 128), np.int16),
        "dc_slab": np.zeros((B, n_slots, 32), np.int16),
        "maxw": g["maxw"],
    }


def pack_frames_slots(staging: dict, frames, sps, pps) -> PackedFrames:
    """Records PackedFrames: the coefficient slabs are the staging buffers
    themselves; only the small per-MB metadata arrays are stacked."""
    arrays = _small_arrays(frames)
    B = len(frames)
    for name in ("luma_slab", "chroma_slab", "dc_slab"):
        arrays[name] = staging[name][:B]
    fs0 = frames[0][0]
    return _pack(fs0.width_mbs, fs0.height_mbs, arrays, pps, 1)


def make_slab_staging2(wmb: int, hmb: int, batch: int) -> dict:
    """Staging of the device mode: one MB-major int16 record per
    macroblock [B, n, REC_LEN] (native.REC_*) that the native parser
    writes whole, left unzeroed: zero_uncovered zeroes the records that
    no slice wrote before the batch is packed."""
    return {"records": np.empty((batch, wmb * hmb, REC_LEN), np.int16)}


def zero_uncovered(staging: dict, slice_of_mbs) -> int:
    """Zero the device-mode records that no slice wrote: row i's MBs
    where slice_of_mbs[i] is -1 (a slice that failed leaves its MBs at
    -1, the ones it wrote before the failure too), so they read
    parsed = 0 as in fresh zeroed staging.  Returns their count.  One
    pass over the whole batch: the pipeline's host thread runs it while
    the parse pool contends for the interpreter lock."""
    unwritten = np.stack(slice_of_mbs) < 0
    n = int(np.count_nonzero(unwritten))
    if n:
        staging["records"][:len(unwritten)][unwritten] = 0
    return n


def pack_frames_slots2(staging: dict, sps, pps) -> PackedFrames:
    """PackedFrames over device-mode staging: the records themselves,
    the per-MB metadata riding in their meta rows.  Call zero_uncovered
    first: the staging is not zeroed before the parse."""
    return _pack(sps.pic_width_in_mbs, sps.pic_height_in_map_units,
                 {"records": staging["records"]}, pps, 2)


# ---------------------------------------------------------------------------
# residuals: dequant + inverse transforms of a raster batch (torch ops)


def _assemble_16x16(blocks):
    """[..., 16, 4, 4] in luma4x4BlkIdx order -> [..., 16, 16]."""
    lead = tuple(blocks.shape[:-3])
    b = blocks.reshape(lead + (2, 2, 2, 2, 4, 4))
    # index order: (y8, x8, y4, x4, py, px) -> rows y8,y4,py; cols x8,x4,px
    b = torch.movedim(b, (-6, -4, -2, -5, -3, -1),
                      (-6, -5, -4, -3, -2, -1))
    return b.reshape(lead + (16, 16))


def _assemble_from_8x8(blocks):
    """[..., 4, 8, 8] raster -> [..., 16, 16]."""
    lead = tuple(blocks.shape[:-3])
    b = blocks.reshape(lead + (2, 2, 8, 8))
    b = torch.movedim(b, (-4, -2, -3, -1), (-4, -3, -2, -1))
    return b.reshape(lead + (16, 16))


def _assemble_8x8_from_4(blocks):
    """[..., 4, 4, 4] raster -> [..., 8, 8]."""
    lead = tuple(blocks.shape[:-3])
    b = blocks.reshape(lead + (2, 2, 4, 4))
    b = torch.movedim(b, (-4, -2, -3, -1), (-4, -3, -2, -1))
    return b.reshape(lead + (8, 8))


_BLK_ROW = (BLK4x4_POS[:, 1] // 4).astype(np.int64)   # blkIdx -> dc row
_BLK_COL = (BLK4x4_POS[:, 0] // 4).astype(np.int64)

_QPC_TAB = np.asarray(QPC_FROM_QPI, np.int32)


def build_residuals(arr, ls4, ls8, cb_off, cr_off):
    """Phase 1: fully-batched residual construction of raster staging
    `arr` (int tensors, all on one device; the result lies there too).

    Returns dict with r4 [B,n,16,4,4], r8 [B,n,4,8,8],
    luma16_res [B,n,16,16], chroma_res [B,n,2,8,8] int32."""
    kind = arr["mb_kind"]                       # [B, n]
    qp = arr["qpy"].to(torch.int32)
    B, n = kind.shape
    dev = kind.device

    ls4 = torch.as_tensor(np.asarray(ls4, np.int32), device=dev)
    ls8 = torch.as_tensor(np.asarray(ls8, np.int32), device=dev)

    # luma 4x4 blocks
    qp16 = qp[..., None].expand(B, n, 16).reshape(-1)
    c4t, _ = to_comp_first(arr["luma_ac"].to(torch.int32), 4, 4)
    d4t = dequant_4x4_t(c4t, qp16, ls4[0])
    dc = luma_dc_transform(arr["luma_dc"], qp, ls4[0])       # [B,n,4,4]
    dc_per_blk = dc[..., torch.as_tensor(_BLK_ROW, device=dev),
                    torch.as_tensor(_BLK_COL, device=dev)].reshape(-1)
    is16 = (kind == KIND_I16x16)[..., None].expand(B, n, 16).reshape(-1)
    d4t[0, 0] = torch.where(is16, dc_per_blk, d4t[0, 0])
    r4 = from_comp_first(idct_4x4_t(d4t), (B, n, 16), 4, 4)

    # luma 8x8 blocks
    qp4 = qp[..., None].expand(B, n, 4).reshape(-1)
    c8t, _ = to_comp_first(arr["luma8x8_coeff"].to(torch.int32), 8, 8)
    r8 = from_comp_first(idct_8x8_t(dequant_8x8_t(c8t, qp4, ls8)),
                         (B, n, 4), 8, 8)

    # assembled luma residual for I16x16 / PCM
    pcm_luma = arr["luma_ac"].reshape(B, n, 16, 16).to(torch.int32)
    luma16_res = torch.where((kind == KIND_IPCM)[..., None, None],
                             pcm_luma, _assemble_16x16(r4))

    # chroma
    qpc_tab = torch.as_tensor(_QPC_TAB, device=dev)
    blk_r = torch.tensor([0, 0, 1, 1], device=dev)
    blk_c = torch.tensor([0, 1, 0, 1], device=dev)
    chroma_parts = []
    for ic, off in enumerate((cb_off, cr_off)):
        qpc = qpc_tab[(qp + off).clamp(0, 51).long()]        # [B,n]
        qpc4 = qpc[..., None].expand(B, n, 4).reshape(-1)
        dci = chroma_dc_transform(arr["chroma_dc"][:, :, ic], qpc,
                                  ls4[1 + ic])               # [B,n,2,2]
        cct, _ = to_comp_first(arr["chroma_ac"][:, :, ic].to(torch.int32),
                               4, 4)
        dcht = dequant_4x4_t(cct, qpc4, ls4[1 + ic])
        dcht[0, 0] = dci[..., blk_r, blk_c].reshape(-1)      # [B*n*4]
        rc4 = from_comp_first(idct_4x4_t(dcht), (B, n, 4), 4, 4)
        chroma_parts.append(_assemble_8x8_from_4(rc4))       # [B,n,8,8]
    chroma_res = torch.stack(chroma_parts, dim=2)            # [B,n,2,8,8]
    pcm_chroma = arr["chroma_ac"].reshape(B, n, 2, 8, 8).to(torch.int32)
    chroma_res = torch.where((kind == KIND_IPCM)[..., None, None, None],
                             pcm_chroma, chroma_res)

    return {"r4": r4, "r8": r8, "luma16_res": luma16_res,
            "chroma_res": chroma_res}

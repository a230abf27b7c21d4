"""Frame packing for the fused engine: staging buffers and PackedFrames.

Port of the packing half of minivideo_tpu/ops/recon.py, in its three
staging layouts (`PackedFrames.slots`):

  0 raster  - `pack_frames` stacks full FrameSyntax arrays (the Python
              parsers' or the native raster parse's), I_PCM samples in the
              coefficient buffers;
  1 records - `make_slab_staging` holds int16 slab records in skew-slot
              order that the native parser writes; `pack_frames_slots`
              stacks the per-MB metadata beside them;
  2 device  - `make_slab_staging2` holds the kernel's per-wave feeds
              [B, W, S, maxw] with the meta rows, written by the native
              parser; `pack_frames_slots2` wraps them.

ops/slab.py turns layouts 0 and 1 into layout 2 on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..models.h264.spatial import _blk4x4_at
from ..models.h264.syntax import KIND_IPCM, FrameSyntax
from ..models.h264.tables import BLK4x4_POS
from .transform import level_scale_4x4_np, level_scale_8x8_np

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
    slots=2: meta_slab [B, W, META_ROWS, maxw] int32 and luma/chroma/dc
    slabs [B, W, 256|128|32, maxw] int16.  Arrays are numpy arrays or
    torch tensors."""
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
            return self.arrays["meta_slab"].shape[0]
        return self.arrays["mb_kind"].shape[0]

    @cached_property
    def haspcm(self) -> bool:
        """True if any MB in the batch is I_PCM (scanned once per pack)."""
        if self.slots == 2:
            kinds = self.arrays["meta_slab"][:, :, 0]
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
    """Device-layout staging for the native parser's v2 slab mode:
    frame-major [B, W, S, maxw] buffers, one disjoint contiguous region
    per frame.  np.zeros maps lazy zero pages; unwritten slots keep
    parsed=0."""
    from .recon_wave import skew_tables
    from .slab import META_ROWS
    g = skew_tables(wmb, hmb)
    W, maxw = g["n_waves"], g["maxw"]
    B = batch
    return {
        "luma_slab": np.zeros((B, W, 256, maxw), np.int16),
        "chroma_slab": np.zeros((B, W, 128, maxw), np.int16),
        "dc_slab": np.zeros((B, W, 32, maxw), np.int16),
        "meta_slab": np.zeros((B, W, META_ROWS, maxw), np.int32),
        "maxw": maxw,
        "batch": B,
    }


def pack_frames_slots2(staging: dict, sps, pps) -> PackedFrames:
    """PackedFrames over v2 staging: the arrays are the staging buffers
    themselves; per-MB metadata rides in the parser-emitted meta slab."""
    arrays = {k: staging[k] for k in ("luma_slab", "chroma_slab",
                                      "dc_slab", "meta_slab")}
    return _pack(sps.pic_width_in_mbs, sps.pic_height_in_map_units, arrays,
                 pps, 2)

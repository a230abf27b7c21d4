"""Frame packing for the fused engine: slab staging and PackedFrames.

Port of the device-layout (v2) staging of minivideo_tpu/ops/recon.py:
`make_slab_staging2` allocates the buffers the native parser writes the
kernel's per-wave feeds into, and `pack_frames_slots2` wraps them with
the stream's scale tables as a `PackedFrames`.  The raster and
slot-record layouts of that module are not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..models.h264.syntax import KIND_IPCM
from ..models.h264.tables import BLK4x4_POS
from .transform import level_scale_4x4_np, level_scale_8x8_np


def _blk4x4_at(x: int, y: int) -> int:
    """luma4x4BlkIdx covering luma position (x, y) (spec 6.4.13.1)."""
    return (8 * (y // 8) + 4 * (x // 8)
            + 2 * ((y % 8) // 4) + ((x % 8) // 4))


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
    """Batch of parsed frames sharing one MB-grid geometry, in the
    device (v2) staging layout: `arrays` holds meta_slab
    [B, W, META_ROWS, maxw] int32 and luma/chroma/dc slabs
    [B, W, 256|128|32, maxw] int16, as numpy arrays or torch tensors."""
    wmb: int
    hmb: int
    arrays: dict          # name -> array, leading dim = batch
    ls4: np.ndarray       # [3, 6, 4, 4] luma/Cb/Cr intra LevelScale
    ls8: np.ndarray       # [6, 8, 8]
    chroma_qp_off: tuple  # (cb_offset, cr_offset)
    has8x8: bool = True   # PPS transform_8x8_mode_flag (static per stream)

    @property
    def batch(self) -> int:
        return self.arrays["meta_slab"].shape[0]

    @cached_property
    def haspcm(self) -> bool:
        """True if any MB in the batch is I_PCM (scanned once per pack)."""
        kinds = self.arrays["meta_slab"][:, :, 0]
        return bool((kinds == KIND_IPCM).any())


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
    wmb = sps.pic_width_in_mbs
    hmb = sps.pic_height_in_map_units
    arrays = {k: staging[k] for k in ("luma_slab", "chroma_slab",
                                      "dc_slab", "meta_slab")}
    ls4 = np.stack([level_scale_4x4_np(pps.scaling_list_4x4[i])
                    for i in range(3)])
    ls8 = level_scale_8x8_np(pps.scaling_list_8x8[0])
    return PackedFrames(wmb, hmb, arrays, ls4, ls8,
                        (pps.chroma_qp_index_offset,
                         pps.second_chroma_qp_index_offset),
                        has8x8=bool(pps.transform_8x8_mode_flag))

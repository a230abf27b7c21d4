"""Macroblock-layer syntax parsing for I slices -> dense per-frame arrays.

This is the host-side "entropy phase" of the two-phase decoder design
(SURVEY.md §7): it consumes slice_data() bit-by-bit (CAVLC here; CABAC in
cabac.py) and emits a `FrameSyntax` of static-shaped numpy arrays — modes,
QPs, and raster-order coefficient blocks — which the device reconstruction
phase (ops/) consumes without any bitstream logic.

Reference: minivideo/src/decoder/h264/h264_macroblock.c (macroblock_layer
:75-321, residual_luma/chroma :1102-1307) and h264_slice.c
(decodeSliceData :1013-1139).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitio import BitReader, BitstreamError
from . import trace
from .cavlc import residual_block_cavlc
from .expgolomb import read_me_cbp, read_se, read_ue
from .params import PPS, SPS, UnsupportedStream
from .slicehdr import SliceHeader
from .spatial import (A, B, chroma4x4_neighbor, luma4x4_neighbor,
                      luma8x8_neighbor, mb_neighbors)
from .tables import ZIGZAG_4x4, ZIGZAG_8x8

# mb kinds (derived classification of I-slice mb_type, Table 7-11)
KIND_I4x4 = 0
KIND_I16x16 = 1
KIND_IPCM = 2
KIND_I8x8 = 3

MODE_DC = 2  # DC intra pred mode index (both 4x4 and 16x16 numbering)


@dataclass
class FrameSyntax:
    """Parsed syntax of one I picture: static-shaped arrays, nmb = wmb*hmb.

    lite=True skips the five large raster coefficient buffers — for the
    native parser's slab mode, which writes coefficients into external
    slot-ordered staging instead (ops/recon.make_slab_staging)."""
    width_mbs: int
    height_mbs: int
    lite: bool = False

    mb_kind: np.ndarray = None        # [nmb] int8
    qpy: np.ndarray = None            # [nmb] int32 (after delta chain)
    i16_mode: np.ndarray = None       # [nmb] int8
    chroma_mode: np.ndarray = None    # [nmb] int8
    luma4x4_modes: np.ndarray = None  # [nmb,16] int8 (resolved)
    luma8x8_modes: np.ndarray = None  # [nmb,4] int8 (resolved)
    cbp_luma: np.ndarray = None       # [nmb] int8 bits per 8x8
    cbp_chroma: np.ndarray = None     # [nmb] int8 0/1/2
    # coefficients, raster order within blocks:
    luma_dc: np.ndarray = None        # [nmb,4,4] int32 (I16x16 DC)
    luma_ac: np.ndarray = None        # [nmb,16,4,4] int32 (4x4 blocks;
    #                                    I16x16: AC with [0,0]=0)
    luma8x8_coeff: np.ndarray = None  # [nmb,4,8,8] int32 (8x8 blocks)
    chroma_dc: np.ndarray = None      # [nmb,2,2,2] int32
    chroma_ac: np.ndarray = None      # [nmb,2,4,4,4] int32 ([0,0]=0)
    pcm_y: dict = field(default_factory=dict)    # mb_addr -> [16,16] uint8
    pcm_cb: dict = field(default_factory=dict)   # mb_addr -> [8,8] uint8
    pcm_cr: dict = field(default_factory=dict)
    # parse state (CAVLC nC / CABAC ctx derivations)
    total_coeff_luma: np.ndarray = None    # [nmb,16] int16
    total_coeff_chroma: np.ndarray = None  # [nmb,2,4] int16
    # CABAC parse state (coded_block_flag per block, see cabac.py)
    cbf_luma_dc: np.ndarray = None    # [nmb]
    cbf_luma: np.ndarray = None       # [nmb,16]
    cbf_luma8x8: np.ndarray = None    # [nmb,4]
    cbf_chroma_dc: np.ndarray = None  # [nmb,2]
    cbf_chroma: np.ndarray = None     # [nmb,2,4]
    transform8x8: np.ndarray = None   # [nmb] int8
    parsed: np.ndarray = None         # [nmb] bool (true once decoded)

    def __post_init__(self):
        n = self.width_mbs * self.height_mbs
        self.mb_kind = np.zeros(n, dtype=np.int8)
        self.qpy = np.zeros(n, dtype=np.int32)
        self.i16_mode = np.zeros(n, dtype=np.int8)
        self.chroma_mode = np.zeros(n, dtype=np.int8)
        self.luma4x4_modes = np.full((n, 16), MODE_DC, dtype=np.int8)
        self.luma8x8_modes = np.full((n, 4), MODE_DC, dtype=np.int8)
        self.cbp_luma = np.zeros(n, dtype=np.int8)
        self.cbp_chroma = np.zeros(n, dtype=np.int8)
        cn = 1 if self.lite else n
        self.luma_dc = np.zeros((cn, 4, 4), dtype=np.int32)
        self.luma_ac = np.zeros((cn, 16, 4, 4), dtype=np.int32)
        self.luma8x8_coeff = np.zeros((cn, 4, 8, 8), dtype=np.int32)
        self.chroma_dc = np.zeros((cn, 2, 2, 2), dtype=np.int32)
        self.chroma_ac = np.zeros((cn, 2, 4, 4, 4), dtype=np.int32)
        self.total_coeff_luma = np.zeros((n, 16), dtype=np.int16)
        self.total_coeff_chroma = np.zeros((n, 2, 4), dtype=np.int16)
        self.cbf_luma_dc = np.zeros(n, dtype=np.int8)
        self.cbf_luma = np.zeros((n, 16), dtype=np.int8)
        self.cbf_luma8x8 = np.zeros((n, 4), dtype=np.int8)
        self.cbf_chroma_dc = np.zeros((n, 2), dtype=np.int8)
        self.cbf_chroma = np.zeros((n, 2, 4), dtype=np.int8)
        self.transform8x8 = np.zeros(n, dtype=np.int8)
        self.parsed = np.zeros(n, dtype=bool)

    @property
    def n_mbs(self) -> int:
        return self.width_mbs * self.height_mbs


def i16x16_decompose(mb_type: int):
    """I_16x16 mb_type (1..24) -> (predMode, cbpChroma, cbpLuma)
    (spec Table 7-11)."""
    t = mb_type - 1
    return t % 4, (t // 4) % 3, 15 if t >= 12 else 0


def _zigzag_to_raster4(scan_levels) -> np.ndarray:
    out = np.zeros(16, dtype=np.int32)
    out[ZIGZAG_4x4] = scan_levels
    return out.reshape(4, 4)


def _zigzag_to_raster8(scan_levels) -> np.ndarray:
    out = np.zeros(64, dtype=np.int32)
    out[ZIGZAG_8x8] = scan_levels
    return out.reshape(8, 8)


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


class CavlcSliceParser:
    """Parses slice_data() of one I slice with CAVLC entropy coding.

    The caller provides the shared FrameSyntax (one per picture; a picture
    may span multiple slices).
    """

    def __init__(self, r: BitReader, sh: SliceHeader, sps: SPS, pps: PPS,
                 fs: FrameSyntax):
        self.r = r
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.fs = fs
        self.first_mb = sh.first_mb_in_slice
        self.resolver = IntraModeResolver(fs, self.first_mb,
                                          bool(pps.constrained_intra_pred_flag))
        self.qpy_prev = sh.qp

    # -- nC derivation (spec 9.2.1) -----------------------------------------

    def _nc_luma(self, mb_addr: int, blk: int) -> int:
        return self._nc(mb_addr, blk, luma4x4_neighbor,
                        self.fs.total_coeff_luma, None)

    def _nc_chroma(self, mb_addr: int, icbcr: int, blk: int) -> int:
        return self._nc(mb_addr, blk, chroma4x4_neighbor,
                        self.fs.total_coeff_chroma, icbcr)

    def _nc(self, mb_addr, blk, neigh_fn, store, icbcr):
        fs = self.fs
        ns = []
        for which in (A, B):
            mb_n, blk_n = neigh_fn(mb_addr, blk, which, fs.width_mbs,
                                   self.first_mb)
            if mb_n < 0 or not fs.parsed[mb_n]:
                ns.append(-1)
            elif fs.mb_kind[mb_n] == KIND_IPCM:
                ns.append(16)
            elif icbcr is None:
                ns.append(int(store[mb_n, blk_n]))
            else:
                ns.append(int(store[mb_n, icbcr, blk_n]))
        na, nb = ns
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return na
        if nb >= 0:
            return nb
        return 0

    # -- macroblock layer ----------------------------------------------------

    def parse_macroblock(self, mb_addr: int) -> None:
        """macroblock_layer() for I slices, CAVLC (spec 7.3.5).

        Reference: macroblock_layer (h264_macroblock.c:75-321)."""
        r, fs = self.r, self.fs
        mb_type = read_ue(r)
        if mb_type > 25:
            raise BitstreamError(f"invalid I-slice mb_type {mb_type}")
        trace.t3("MB", "mb %d: type %d", mb_addr, mb_type)

        if mb_type == 25:  # I_PCM
            self._parse_ipcm(mb_addr)
            return

        if mb_type == 0:  # I_NxN
            transform8x8 = 0
            if self.pps.transform_8x8_mode_flag:
                transform8x8 = r.read_bit()
            fs.transform8x8[mb_addr] = transform8x8
            fs.mb_kind[mb_addr] = KIND_I8x8 if transform8x8 else KIND_I4x4
            fs.parsed[mb_addr] = True
            self._parse_intra_nxn_pred(mb_addr, transform8x8)
            fs.chroma_mode[mb_addr] = self._read_chroma_mode()
            cbp = read_me_cbp(r, self.sps.chroma_array_type, intra=True)
            fs.cbp_luma[mb_addr] = cbp & 15
            fs.cbp_chroma[mb_addr] = cbp >> 4
        else:  # I_16x16
            i16_mode, cbp_c, cbp_l = i16x16_decompose(mb_type)
            fs.mb_kind[mb_addr] = KIND_I16x16
            fs.parsed[mb_addr] = True
            fs.i16_mode[mb_addr] = i16_mode
            fs.cbp_luma[mb_addr] = cbp_l
            fs.cbp_chroma[mb_addr] = cbp_c
            fs.chroma_mode[mb_addr] = self._read_chroma_mode()

        cbp_l = int(fs.cbp_luma[mb_addr])
        cbp_c = int(fs.cbp_chroma[mb_addr])
        is_i16 = fs.mb_kind[mb_addr] == KIND_I16x16

        if cbp_l or cbp_c or is_i16:
            delta = read_se(r)
            if not (-27 < delta < 26):
                raise BitstreamError(f"mb_qp_delta {delta} out of range")
            self.qpy_prev = (self.qpy_prev + delta + 52) % 52
        fs.qpy[mb_addr] = self.qpy_prev

        self._parse_residual(mb_addr, is_i16, cbp_l, cbp_c)

    def _read_chroma_mode(self) -> int:
        m = read_ue(self.r)
        if m > 3:
            raise BitstreamError(f"intra_chroma_pred_mode {m} invalid")
        return m

    def _parse_ipcm(self, mb_addr: int) -> None:
        """I_PCM (spec 7.3.5; reference h264_macroblock.c:118-154)."""
        r, fs = self.r, self.fs
        r.align()  # pcm_alignment_zero_bit
        y = np.frombuffer(r.read_bytes(256), dtype=np.uint8).reshape(16, 16)
        cb = np.frombuffer(r.read_bytes(64), dtype=np.uint8).reshape(8, 8)
        cr = np.frombuffer(r.read_bytes(64), dtype=np.uint8).reshape(8, 8)
        fs.mb_kind[mb_addr] = KIND_IPCM
        fs.parsed[mb_addr] = True
        fs.pcm_y[mb_addr] = y.copy()
        fs.pcm_cb[mb_addr] = cb.copy()
        fs.pcm_cr[mb_addr] = cr.copy()
        fs.total_coeff_luma[mb_addr, :] = 16
        fs.total_coeff_chroma[mb_addr, :, :] = 16
        # QPY unchanged; cbf for CABAC neighbors = 1 by convention
        fs.qpy[mb_addr] = self.qpy_prev
        fs.cbf_luma[mb_addr, :] = 1
        fs.cbf_luma8x8[mb_addr, :] = 1
        fs.cbf_luma_dc[mb_addr] = 1
        fs.cbf_chroma_dc[mb_addr, :] = 1
        fs.cbf_chroma[mb_addr, :, :] = 1

    def _parse_intra_nxn_pred(self, mb_addr: int, transform8x8: int) -> None:
        """mb_pred() intra mode syntax (spec 7.3.5.1; reference
        h264_macroblock.c:393-527)."""
        r, fs = self.r, self.fs
        if transform8x8:
            for blk8 in range(4):
                mode = self._read_pred_mode(
                    self.resolver.predicted_8x8_mode(mb_addr, blk8))
                fs.luma8x8_modes[mb_addr, blk8] = mode
        else:
            for blk in range(16):
                mode = self._read_pred_mode(
                    self.resolver.predicted_4x4_mode(mb_addr, blk))
                fs.luma4x4_modes[mb_addr, blk] = mode

    def _read_pred_mode(self, predicted: int) -> int:
        r = self.r
        if r.read_bit():  # prev_intra_pred_mode_flag
            return predicted
        rem = r.read_bits(3)
        return rem if rem < predicted else rem + 1

    # -- residuals -----------------------------------------------------------

    def _parse_residual(self, mb_addr: int, is_i16: bool, cbp_l: int,
                        cbp_c: int) -> None:
        """residual() CAVLC (spec 7.3.5.3; reference residual_luma/chroma
        h264_macroblock.c:1102-1307)."""
        r, fs = self.r, self.fs
        transform8x8 = bool(fs.transform8x8[mb_addr])

        if is_i16:
            nc = self._nc_luma(mb_addr, 0)
            levels, _ = residual_block_cavlc(r, nc, 0, 15, 16)
            fs.luma_dc[mb_addr] = _zigzag_to_raster4(levels)

        for blk8 in range(4):
            coded = bool(cbp_l & (1 << blk8))
            if transform8x8:
                # CAVLC 8x8: four interleaved 4x4 parses (spec 7.3.5.3.2)
                lvl64 = np.zeros(64, dtype=np.int64)
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if coded:
                        nc = self._nc_luma(mb_addr, blk)
                        levels, tc = residual_block_cavlc(r, nc, 0, 15, 16)
                        fs.total_coeff_luma[mb_addr, blk] = tc
                        lvl64[np.arange(16) * 4 + i4] = levels
                if coded:
                    fs.luma8x8_coeff[mb_addr, blk8] = _zigzag_to_raster8(lvl64)
            else:
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if not coded:
                        continue
                    nc = self._nc_luma(mb_addr, blk)
                    if is_i16:
                        levels, tc = residual_block_cavlc(r, nc, 0, 14, 15)
                        full = [0] + list(levels)
                    else:
                        full, tc = residual_block_cavlc(r, nc, 0, 15, 16)
                    fs.total_coeff_luma[mb_addr, blk] = tc
                    fs.luma_ac[mb_addr, blk] = _zigzag_to_raster4(full)

        # chroma, 4:2:0 (ChromaArrayType 1)
        if cbp_c:
            for icbcr in range(2):
                nc = -1
                levels, _ = residual_block_cavlc(r, nc, 0, 3, 4)
                fs.chroma_dc[mb_addr, icbcr] = np.asarray(
                    levels, dtype=np.int32).reshape(2, 2)
        if cbp_c & 2:
            for icbcr in range(2):
                for blk in range(4):
                    nc = self._nc_chroma(mb_addr, icbcr, blk)
                    levels, tc = residual_block_cavlc(r, nc, 0, 14, 15)
                    full = [0] + list(levels)
                    fs.total_coeff_chroma[mb_addr, icbcr, blk] = tc
                    fs.chroma_ac[mb_addr, icbcr, blk] = \
                        _zigzag_to_raster4(full)

    # -- slice data loop -----------------------------------------------------

    def parse_slice_data(self) -> int:
        """Decode MBs until the RBSP is exhausted (spec 7.3.4 CAVLC;
        reference decodeSliceData h264_slice.c:1013-1139).  Returns the
        number of macroblocks decoded."""
        fs = self.fs
        mb_addr = self.first_mb
        n = fs.n_mbs
        while self.r.h264_more_rbsp_data():
            if mb_addr >= n:
                raise BitstreamError("slice data overruns picture")
            self.parse_macroblock(mb_addr)
            mb_addr += 1
        return mb_addr - self.first_mb

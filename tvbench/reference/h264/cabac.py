"""CABAC entropy decoding for I slices (ITU-T H.264 clause 9.3).

Reference: minivideo/src/decoder/h264/h264_cabac.c (engine :2342-2563,
binarizations :619-1195, ctxIdx derivations :1338-2340) + tables.
NOTE: the reference's CABAC "still has a few bugs" (README.md:22); this
implementation follows the spec, not the reference's behavior.

`CabacSliceParser` mirrors `CavlcSliceParser` (syntax.py): it fills the
same `FrameSyntax` arrays, so the reconstruction phases (numpy oracle and
the TPU engines) are entropy-coder agnostic.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitReader, BitstreamError
from . import trace
from .cabac_tables import (CONTEXT_INIT_I, LAST8x8, RANGE_TAB_LPS,
                           SIG8x8_FRAME, TRANS_IDX_LPS, TRANS_IDX_MPS)
from .params import PPS, SPS
from .slicehdr import SliceHeader
from .spatial import (A, B, chroma4x4_neighbor, luma4x4_neighbor,
                      luma8x8_neighbor, mb_neighbors)
from .syntax import (FrameSyntax, IntraModeResolver, KIND_I4x4, KIND_I8x8,
                     KIND_I16x16, KIND_IPCM, _zigzag_to_raster4,
                     _zigzag_to_raster8, i16x16_decompose)

# block categories (spec Table 9-42)
CAT_LUMA_DC = 0      # Intra16x16DCLevel
CAT_LUMA_AC = 1      # Intra16x16ACLevel
CAT_LUMA_4x4 = 2     # LumaLevel4x4
CAT_CHROMA_DC = 3
CAT_CHROMA_AC = 4
CAT_LUMA_8x8 = 5

# ctxIdxOffset bases (spec Table 9-34)
_BASE_SIG = 105
_BASE_LAST = 166
_BASE_ABS = 227
_BASE_SIG8 = 402
_BASE_LAST8 = 417
_BASE_ABS8 = 426

# ctxBlockCatOffset (spec Table 9-40) for [sig, last, abs] by category 0-4
_CAT_OFF_SIG = (0, 15, 29, 44, 47)
_CAT_OFF_LAST = (0, 15, 29, 44, 47)
_CAT_OFF_ABS = (0, 10, 20, 30, 39)
# coded_block_flag: base 85, catOffset (0, 4, 8, 12, 16)
_CAT_OFF_CBF = (0, 4, 8, 12, 16)


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


class CabacEngine:
    """Arithmetic decoding engine (spec 9.3.3.2) + context memory."""

    def __init__(self, r: BitReader, slice_qp: int):
        # context init (spec 9.3.1.1, cabac_init_idc n/a for I slices)
        self.state = np.zeros(460, dtype=np.int32)    # pStateIdx
        self.mps = np.zeros(460, dtype=np.int32)      # valMPS
        qp = _clip3(0, 51, slice_qp)
        for i, (m, n) in enumerate(CONTEXT_INIT_I):
            pre = _clip3(1, 126, ((m * qp) >> 4) + n)
            if pre <= 63:
                self.state[i] = 63 - pre
                self.mps[i] = 0
            else:
                self.state[i] = pre - 64
                self.mps[i] = 1
        self.r = r
        self.cod_range = 510
        self.cod_offset = r.read_bits(9)

    def decode_decision(self, ctx: int) -> int:
        st = int(self.state[ctx])
        q = (self.cod_range >> 6) & 3
        r_lps = RANGE_TAB_LPS[st][q]
        self.cod_range -= r_lps
        if self.cod_offset >= self.cod_range:
            bin_val = 1 - int(self.mps[ctx])
            self.cod_offset -= self.cod_range
            self.cod_range = r_lps
            if st == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = TRANS_IDX_LPS[st]
        else:
            bin_val = int(self.mps[ctx])
            self.state[ctx] = TRANS_IDX_MPS[st]
        # renormalisation (spec 9.3.3.2.2)
        while self.cod_range < 256:
            self.cod_range <<= 1
            self.cod_offset = (self.cod_offset << 1) | self.r.read_bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.cod_offset = (self.cod_offset << 1) | self.r.read_bit()
        if self.cod_offset >= self.cod_range:
            self.cod_offset -= self.cod_range
            return 1
        return 0

    def decode_terminate(self) -> int:
        self.cod_range -= 2
        if self.cod_offset >= self.cod_range:
            return 1
        while self.cod_range < 256:
            self.cod_range <<= 1
            self.cod_offset = (self.cod_offset << 1) | self.r.read_bit()
        return 0

    def reinit(self) -> None:
        """Re-initialise the engine after I_PCM (spec 9.3.1.2); context
        variables persist."""
        self.cod_range = 510
        self.cod_offset = self.r.read_bits(9)


class ContextDeriv:
    """ctxIdxInc derivations shared by the decoder and the fixture
    encoder (spec 9.3.3.1.1.x); operates on a FrameSyntax."""

    def __init__(self, fs: FrameSyntax, first_mb: int):
        self.fs = fs
        self.first_mb = first_mb

    # ---- neighbor helpers -------------------------------------------------

    def _nbr_mb(self, mb_addr, which):
        mb_a, mb_b = mb_neighbors(mb_addr, self.fs.width_mbs, self.first_mb)
        n = mb_a if which == A else mb_b
        if n >= 0 and self.fs.parsed[n]:
            return n
        return -1

    def _cond_mbtype(self, mb_addr):
        """ctxIdxInc for mb_type bin 0 (spec 9.3.3.1.1.3): condTermFlagN=0
        iff unavailable or mb_type == I_NxN."""
        inc = 0
        for which in (A, B):
            n = self._nbr_mb(mb_addr, which)
            if n >= 0 and self.fs.mb_kind[n] not in (KIND_I4x4, KIND_I8x8):
                inc += 1
        return inc

    def _cond_transform8x8(self, mb_addr):
        inc = 0
        for which in (A, B):
            n = self._nbr_mb(mb_addr, which)
            if n >= 0 and self.fs.transform8x8[n]:
                inc += 1
        return inc

    def _cond_chroma_pred(self, mb_addr):
        inc = 0
        for which in (A, B):
            n = self._nbr_mb(mb_addr, which)
            if n >= 0 and self.fs.mb_kind[n] != KIND_IPCM \
                    and self.fs.chroma_mode[n] != 0:
                inc += 1
        return inc

    def _cond_cbp_luma(self, mb_addr, blk8):
        """ctxIdxInc for coded_block_pattern luma bin (spec 9.3.3.1.1.4):
        condTermFlagN = 0 if unavailable / I_PCM / neighbor bit set."""
        incs = []
        for which in (A, B):
            mb_n, blk_n = luma8x8_neighbor(mb_addr, blk8, which,
                                           self.fs.width_mbs, self.first_mb)
            if mb_n == mb_addr:
                bit = (int(self.fs.cbp_luma[mb_addr]) >> blk_n) & 1
                incs.append(0 if bit else 1)
            elif mb_n < 0 or not self.fs.parsed[mb_n]:
                incs.append(0)
            elif self.fs.mb_kind[mb_n] == KIND_IPCM:
                incs.append(0)
            else:
                bit = (int(self.fs.cbp_luma[mb_n]) >> blk_n) & 1
                incs.append(0 if bit else 1)
        return incs[0] + 2 * incs[1]

    def _cond_cbp_chroma(self, mb_addr, binidx):
        incs = []
        for which in (A, B):
            n = self._nbr_mb(mb_addr, which)
            if n < 0:
                incs.append(0)
            elif self.fs.mb_kind[n] == KIND_IPCM:
                incs.append(1)
            else:
                c = int(self.fs.cbp_chroma[n])
                incs.append((1 if c != 0 else 0) if binidx == 0
                            else (1 if c == 2 else 0))
        return incs[0] + 2 * incs[1]

    def _cond_cbf(self, mb_addr, cat, blk):
        """ctxIdxInc for coded_block_flag (spec 9.3.3.1.1.9)."""
        fs = self.fs
        incs = []
        for which in (A, B):
            if cat == CAT_LUMA_DC:
                n = self._nbr_mb(mb_addr, which)
                if n < 0:
                    incs.append(1)      # unavailable + intra current
                elif fs.mb_kind[n] == KIND_IPCM:
                    incs.append(1)
                elif fs.mb_kind[n] == KIND_I16x16:
                    incs.append(int(fs.cbf_luma_dc[n]))
                else:
                    incs.append(0)      # neighbor has no DC block
                continue
            if cat in (CAT_LUMA_AC, CAT_LUMA_4x4):
                mb_n, blk_n = luma4x4_neighbor(mb_addr, blk, which,
                                               fs.width_mbs, self.first_mb)
                if mb_n < 0 or (mb_n != mb_addr and not fs.parsed[mb_n]):
                    incs.append(1)
                    continue
                if fs.mb_kind[mb_n] == KIND_IPCM:
                    incs.append(1)
                elif fs.transform8x8[mb_n]:
                    # 4x4 block maps to covering 8x8 block; its cbf is
                    # the cbp bit (cat-5 blocks carry no coded_block_flag)
                    incs.append((int(fs.cbp_luma[mb_n]) >> (blk_n >> 2)) & 1)
                elif (int(fs.cbp_luma[mb_n]) >> (blk_n >> 2)) & 1 == 0:
                    incs.append(0)      # block not coded -> absent
                else:
                    incs.append(int(fs.cbf_luma[mb_n, blk_n]))
                continue
            if cat == CAT_CHROMA_DC:
                n = self._nbr_mb(mb_addr, which)
                if n < 0:
                    incs.append(1)
                elif fs.mb_kind[n] == KIND_IPCM:
                    incs.append(1)
                elif int(fs.cbp_chroma[n]) != 0:
                    incs.append(int(fs.cbf_chroma_dc[n, blk]))
                else:
                    incs.append(0)
                continue
            # CAT_CHROMA_AC: blk = (iCbCr, blk4)
            icbcr, blk4 = blk
            mb_n, blk_n = chroma4x4_neighbor(mb_addr, blk4, which,
                                             fs.width_mbs, self.first_mb)
            if mb_n < 0 or (mb_n != mb_addr and not fs.parsed[mb_n]):
                incs.append(1)
            elif fs.mb_kind[mb_n] == KIND_IPCM:
                incs.append(1)
            elif int(fs.cbp_chroma[mb_n]) == 2:
                incs.append(int(fs.cbf_chroma[mb_n, icbcr, blk_n]))
            else:
                incs.append(0)
        return incs[0] + 2 * incs[1]


class CabacSliceParser(ContextDeriv):
    """Parses slice_data() of one I slice with CABAC entropy coding."""

    def __init__(self, rbsp: bytes, sh: SliceHeader, sps: SPS, pps: PPS,
                 fs: FrameSyntax):
        super().__init__(fs, sh.first_mb_in_slice)
        r = BitReader(rbsp, start_bit=sh.data_bit_offset)
        r.align()                       # cabac_alignment_one_bit(s)
        self.r = r
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.resolver = IntraModeResolver(
            fs, self.first_mb, bool(pps.constrained_intra_pred_flag))
        self.qpy_prev = sh.qp
        self.prev_qp_delta = 0
        self.engine = CabacEngine(r, sh.qp)

    # ---- binarized syntax elements ----------------------------------------

    def _mb_type(self, mb_addr) -> int:
        """mb_type for I slices (spec 9.3.2.5 + Table 9-39,
        ctxIdxOffset 3)."""
        e = self.engine
        if e.decode_decision(3 + self._cond_mbtype(mb_addr)) == 0:
            return 0                    # I_NxN
        if e.decode_terminate():
            # no decoder-side flush: the eager reader (9-bit init + one
            # bit per renorm) is already positioned exactly past the
            # arithmetic payload, mirroring EncodeFlush's output
            return 25                   # I_PCM
        cbp_l = 15 if e.decode_decision(3 + 3) else 0
        cbp_c = 0
        if e.decode_decision(3 + 4):
            cbp_c = 2 if e.decode_decision(3 + 5) else 1
        hi = e.decode_decision(3 + 6)
        lo = e.decode_decision(3 + 7)
        pred = 2 * hi + lo
        return 1 + pred + 4 * cbp_c + (12 if cbp_l else 0)

    def _mb_qp_delta(self) -> int:
        """mb_qp_delta (spec 9.3.2.7; ctxIdxOffset 60)."""
        e = self.engine
        inc = 1 if self.prev_qp_delta != 0 else 0
        if e.decode_decision(60 + inc) == 0:
            code = 0
        else:
            code = 1
            if e.decode_decision(62):
                code = 2
                while e.decode_decision(63):
                    code += 1
                    if code > 87:
                        raise BitstreamError("mb_qp_delta runaway")
        # code -> signed value (spec 9.3.2.7)
        if code & 1:
            return (code + 1) >> 1
        return -(code >> 1)

    def _intra_chroma_pred_mode(self, mb_addr) -> int:
        e = self.engine
        if e.decode_decision(64 + self._cond_chroma_pred(mb_addr)) == 0:
            return 0
        if e.decode_decision(67) == 0:
            return 1
        if e.decode_decision(67) == 0:
            return 2
        return 3

    def _prev_rem_intra_mode(self) -> int:
        e = self.engine
        if e.decode_decision(68):
            return -1                   # use predicted
        rem = e.decode_decision(69)
        rem |= e.decode_decision(69) << 1
        rem |= e.decode_decision(69) << 2
        return rem

    def _cbp(self, mb_addr) -> int:
        e = self.engine
        cbp = 0
        for blk8 in range(4):
            inc = self._cond_cbp_luma(mb_addr, blk8)
            if e.decode_decision(73 + inc):
                cbp |= 1 << blk8
            # record partial luma cbp so later bins in this MB see it
            self.fs.cbp_luma[mb_addr] = cbp
        cbp_c = 0
        if e.decode_decision(77 + self._cond_cbp_chroma(mb_addr, 0)):
            cbp_c = 2 if e.decode_decision(
                81 + self._cond_cbp_chroma(mb_addr, 1)) else 1
        return cbp | (cbp_c << 4)

    # ---- residual blocks ---------------------------------------------------

    def _residual_block(self, mb_addr, cat, blk, max_coeff):
        """residual_block_cabac (spec 7.3.5.3.3 + 9.3.2.3/9.3.3.1.3).

        Returns (levels list [max_coeff] in scan order, cbf)."""
        e = self.engine
        levels = [0] * max_coeff

        if cat != CAT_LUMA_8x8:
            inc = self._cond_cbf(mb_addr, cat, blk)
            ctx = 85 + _CAT_OFF_CBF[cat] + inc
            cbf = e.decode_decision(ctx)
            if not cbf:
                return levels, 0
        else:
            cbf = 1                     # inferred for 8x8 luma (4:2:0)

        # significance map
        if cat == CAT_LUMA_8x8:
            sig_base = _BASE_SIG8
            last_base = _BASE_LAST8
        else:
            sig_base = _BASE_SIG + _CAT_OFF_SIG[cat]
            last_base = _BASE_LAST + _CAT_OFF_LAST[cat]
        sig = [0] * max_coeff
        num_coeff = 0
        last_fired = False
        for i in range(max_coeff - 1):
            if cat == CAT_LUMA_8x8:
                sig_inc = SIG8x8_FRAME[i]
                last_inc = LAST8x8[i]
            elif cat == CAT_CHROMA_DC:
                sig_inc = min(i, 2)     # NumC8x8 = 1 for 4:2:0
                last_inc = min(i, 2)
            else:
                sig_inc = i
                last_inc = i
            if e.decode_decision(sig_base + sig_inc):
                sig[i] = 1
                num_coeff = i + 1
                if e.decode_decision(last_base + last_inc):
                    last_fired = True
                    break
        if not last_fired:
            # the final scanning position is inferred significant
            sig[max_coeff - 1] = 1
            num_coeff = max_coeff

        # level decoding, highest frequency first (spec 9.3.2.3)
        if cat == CAT_LUMA_8x8:
            abs_base = _BASE_ABS8
        else:
            abs_base = _BASE_ABS + _CAT_OFF_ABS[cat]
        num_gt1 = 0
        num_eq1 = 0
        for idx in range(num_coeff - 1, -1, -1):
            if not sig[idx]:
                continue
            # coeff_abs_level_minus1: UEG0, uCoff 14
            inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            prefix = 0
            if e.decode_decision(abs_base + inc0):
                prefix = 1
                cap = 3 if cat == CAT_CHROMA_DC else 4
                inc_n = 5 + min(cap, num_gt1)
                while prefix < 14 and e.decode_decision(abs_base + inc_n):
                    prefix += 1
            level = prefix + 1
            if prefix == 14:
                # exp-golomb k=0 suffix in bypass
                k = 0
                while e.decode_bypass():
                    k += 1
                    if k > 30:
                        raise BitstreamError("UEG0 suffix runaway")
                suffix = 0
                for _ in range(k):
                    suffix = (suffix << 1) | e.decode_bypass()
                level += (1 << k) - 1 + suffix
            if level == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            if e.decode_bypass():       # coeff_sign_flag
                level = -level
            levels[idx] = level
        return levels, 1

    # ---- macroblock layer --------------------------------------------------

    def parse_macroblock(self, mb_addr: int) -> None:
        fs = self.fs
        e = self.engine
        mb_type = self._mb_type(mb_addr)
        trace.t3("CABAC", "mb %d: type %d", mb_addr, mb_type)

        if mb_type == 25:               # I_PCM
            self._parse_ipcm(mb_addr)
            return

        if mb_type == 0:
            transform8x8 = 0
            if self.pps.transform_8x8_mode_flag:
                transform8x8 = e.decode_decision(
                    399 + self._cond_transform8x8(mb_addr))
            fs.transform8x8[mb_addr] = transform8x8
            fs.mb_kind[mb_addr] = KIND_I8x8 if transform8x8 else KIND_I4x4
            fs.parsed[mb_addr] = True
            if transform8x8:
                for blk8 in range(4):
                    rem = self._prev_rem_intra_mode()
                    pred = self.resolver.predicted_8x8_mode(mb_addr, blk8)
                    mode = pred if rem < 0 else (
                        rem if rem < pred else rem + 1)
                    fs.luma8x8_modes[mb_addr, blk8] = mode
            else:
                for blk in range(16):
                    rem = self._prev_rem_intra_mode()
                    pred = self.resolver.predicted_4x4_mode(mb_addr, blk)
                    mode = pred if rem < 0 else (
                        rem if rem < pred else rem + 1)
                    fs.luma4x4_modes[mb_addr, blk] = mode
            fs.chroma_mode[mb_addr] = self._intra_chroma_pred_mode(mb_addr)
            cbp = self._cbp(mb_addr)
            fs.cbp_luma[mb_addr] = cbp & 15
            fs.cbp_chroma[mb_addr] = cbp >> 4
        else:
            i16_mode, cbp_c, cbp_l = i16x16_decompose(mb_type)
            fs.mb_kind[mb_addr] = KIND_I16x16
            fs.parsed[mb_addr] = True
            fs.i16_mode[mb_addr] = i16_mode
            fs.cbp_luma[mb_addr] = cbp_l
            fs.cbp_chroma[mb_addr] = cbp_c
            fs.chroma_mode[mb_addr] = self._intra_chroma_pred_mode(mb_addr)

        cbp_l = int(fs.cbp_luma[mb_addr])
        cbp_c = int(fs.cbp_chroma[mb_addr])
        is_i16 = fs.mb_kind[mb_addr] == KIND_I16x16

        if cbp_l or cbp_c or is_i16:
            delta = self._mb_qp_delta()
            if not (-27 < delta < 26):
                raise BitstreamError(f"mb_qp_delta {delta} out of range")
            self.qpy_prev = (self.qpy_prev + delta + 52) % 52
            self.prev_qp_delta = delta
        else:
            self.prev_qp_delta = 0
        fs.qpy[mb_addr] = self.qpy_prev

        self._parse_residual(mb_addr, is_i16, cbp_l, cbp_c)

    def _parse_ipcm(self, mb_addr: int) -> None:
        """I_PCM inside CABAC (spec 7.3.5 + 9.3.1.2): after the terminate
        bin the engine is flushed (done in _mb_type), raw samples are read
        byte-aligned, and the arithmetic engine re-initialises (context
        variables persist)."""
        fs = self.fs
        r = self.r
        r.align()                       # pcm_alignment_zero_bit(s)
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
        fs.qpy[mb_addr] = self.qpy_prev
        self.prev_qp_delta = 0
        fs.cbf_luma[mb_addr, :] = 1
        fs.cbf_luma8x8[mb_addr, :] = 1
        fs.cbf_luma_dc[mb_addr] = 1
        fs.cbf_chroma_dc[mb_addr, :] = 1
        fs.cbf_chroma[mb_addr, :, :] = 1
        self.engine.reinit()

    def _parse_residual(self, mb_addr, is_i16, cbp_l, cbp_c):
        fs = self.fs
        transform8x8 = bool(fs.transform8x8[mb_addr])

        if is_i16:
            levels, cbf = self._residual_block(mb_addr, CAT_LUMA_DC, 0, 16)
            fs.luma_dc[mb_addr] = _zigzag_to_raster4(levels)
            fs.cbf_luma_dc[mb_addr] = cbf

        for blk8 in range(4):
            coded = bool(cbp_l & (1 << blk8))
            if transform8x8:
                if coded:
                    levels, _ = self._residual_block(
                        mb_addr, CAT_LUMA_8x8, blk8, 64)
                    fs.luma8x8_coeff[mb_addr, blk8] = \
                        _zigzag_to_raster8(levels)
                    fs.cbf_luma8x8[mb_addr, blk8] = 1
            else:
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if not coded:
                        continue
                    if is_i16:
                        levels, cbf = self._residual_block(
                            mb_addr, CAT_LUMA_AC, blk, 15)
                        full = [0] + list(levels)
                    else:
                        full, cbf = self._residual_block(
                            mb_addr, CAT_LUMA_4x4, blk, 16)
                    fs.cbf_luma[mb_addr, blk] = cbf
                    fs.luma_ac[mb_addr, blk] = _zigzag_to_raster4(full)

        if cbp_c:
            for icbcr in range(2):
                levels, cbf = self._residual_block(
                    mb_addr, CAT_CHROMA_DC, icbcr, 4)
                fs.chroma_dc[mb_addr, icbcr] = np.asarray(
                    levels, dtype=np.int32).reshape(2, 2)
                fs.cbf_chroma_dc[mb_addr, icbcr] = cbf
        if cbp_c & 2:
            for icbcr in range(2):
                for blk in range(4):
                    levels, cbf = self._residual_block(
                        mb_addr, CAT_CHROMA_AC, (icbcr, blk), 15)
                    full = [0] + list(levels)
                    fs.cbf_chroma[mb_addr, icbcr, blk] = cbf
                    fs.chroma_ac[mb_addr, icbcr, blk] = \
                        _zigzag_to_raster4(full)

    # ---- slice data loop ---------------------------------------------------

    def parse_slice_data(self) -> int:
        """Decode MBs until end_of_slice_flag (spec 7.3.4 CABAC)."""
        fs = self.fs
        mb_addr = self.first_mb
        n = fs.n_mbs
        while True:
            if mb_addr >= n:
                raise BitstreamError("slice data overruns picture")
            self.parse_macroblock(mb_addr)
            mb_addr += 1
            if self.engine.decode_terminate():
                break
        return mb_addr - self.first_mb

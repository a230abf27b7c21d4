"""Minimal H.264 intra-only Annex-B *encoder* for test streams.

Copy of tests/fixtures/h264enc.py wired to the port's own tables, so the
port can make its streams on a machine without the JAX package: the same
arguments give the same bytes (tests/test_torch_isolation.py checks it).

There is no media encoder in the build image and the reference ships no
sample clips, so conformance streams are generated here: syntactically
valid SPS/PPS/IDR streams whose macroblock modes, QPs, and residual
*levels* are chosen (pseudo-)randomly.  The point is not picture quality —
it is that the decoder under test and the reference decoder must produce
bit-identical pictures from the same stream.

Supports: Baseline/High intra, I_PCM, I_4x4 / I_8x8 / I_16x16 modes,
CAVLC residual coding (CABAC added alongside the CABAC decoder),
custom scaling matrices, multiple slices, multiple IDR pictures.
"""

from __future__ import annotations

import numpy as np

from ..models.h264.cavlc import (_CT_LEN, _CT_CODE, _CT_CDC_LEN,
                                 _CT_CDC_CODE, _TZ_LEN, _TZ_CODE,
                                 _TZ_CDC_LEN, _TZ_CDC_CODE, _RB_LEN,
                                 _RB_CODE)
from ..models.h264.expgolomb import ME_CBP_CHROMA_12
from ..models.h264.nalu import escape_rbsp
from ..models.h264.spatial import (A, B, chroma4x4_neighbor,
                                   luma4x4_neighbor)
from ..models.h264.syntax import (FrameSyntax, IntraModeResolver,
                                  KIND_I4x4, KIND_I8x8, KIND_I16x16,
                                  KIND_IPCM)
from ..models.h264.tables import BLK4x4_POS

# which neighbor samples each intra NxN mode requires:
# (needs_left, needs_top, needs_corner)
_MODE_NEEDS = {
    0: (False, True, False),   # V
    1: (True, False, False),   # H
    2: (False, False, False),  # DC
    3: (False, True, False),   # DDL
    4: (True, True, True),     # DDR
    5: (True, True, True),     # VR
    6: (True, True, True),     # HD
    7: (False, True, False),   # VL
    8: (True, False, False),   # HU
}


class BitWriter:
    def __init__(self):
        self.bits = []

    def u(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def ue(self, v: int) -> None:
        code = v + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def rbsp_trailing(self) -> None:
        self.bits.append(1)
        self.align_zero()

    def to_bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _inv_cbp_map(table):
    m = {}
    for code_num, (intra, _inter) in enumerate(table):
        if intra not in m:
            m[intra] = code_num
    return m


CBP_TO_CODENUM_420 = _inv_cbp_map(ME_CBP_CHROMA_12)


def nalu(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | nal_type]) \
        + escape_rbsp(rbsp)


def encode_sps(width_mbs: int, height_mbs: int, profile: int = 66,
               level: int = 30, scaling_lists=None, log2_max_fn: int = 4,
               crop=(0, 0, 0, 0)) -> bytes:
    w = BitWriter()
    w.u(profile, 8)
    w.u(0, 8)        # constraint flags + reserved
    w.u(level, 8)
    w.ue(0)          # sps id
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        w.ue(1)      # chroma_format_idc 4:2:0
        w.ue(0)      # bit_depth_luma_minus8
        w.ue(0)      # bit_depth_chroma_minus8
        w.u(0, 1)    # qpprime_y_zero_transform_bypass
        if scaling_lists is None:
            w.u(0, 1)
        else:
            w.u(1, 1)
            _write_scaling_lists(w, scaling_lists, 8)
    w.ue(log2_max_fn - 4)
    # pic_order_cnt_type 0: the reference misparses type 2 (its SPS parser
    # reads type-1 fields for any nonzero type, h264_parameterset.c) —
    # fixtures stick to type 0 for golden comparability
    w.ue(0)
    w.ue(0)          # log2_max_pic_order_cnt_lsb_minus4
    w.ue(0)          # max_num_ref_frames
    w.u(0, 1)        # gaps_in_frame_num
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.u(1, 1)        # frame_mbs_only
    w.u(0, 1)        # direct_8x8_inference
    if any(crop):
        w.u(1, 1)
        for c in crop:
            w.ue(c)
    else:
        w.u(0, 1)
    w.u(0, 1)        # vui_parameters_present
    w.rbsp_trailing()
    return w.to_bytes()


def _write_scaling_lists(w: BitWriter, lists, count: int) -> None:
    """lists: sequence of (present, values_zigzag_or_None)."""
    for i in range(count):
        present, values = lists[i] if i < len(lists) else (0, None)
        w.u(1 if present else 0, 1)
        if present:
            if values is None:
                # signal "use default" via first delta making nextScale 0
                w.se(-8)
            else:
                last = 8
                for v in values:
                    delta = (int(v) - last) % 256
                    if delta > 127:
                        delta -= 256
                    w.se(delta)
                    last = int(v)


def encode_pps(entropy_cabac: bool = False, qp: int = 26,
               chroma_qp_offset: int = 0, transform_8x8: bool = False,
               second_chroma_qp_offset=None, scaling_lists=None) -> bytes:
    w = BitWriter()
    w.ue(0)          # pps id
    w.ue(0)          # sps id
    w.u(1 if entropy_cabac else 0, 1)
    w.u(0, 1)        # bottom_field_pic_order
    w.ue(0)          # num_slice_groups_minus1
    w.ue(0)          # num_ref_idx_l0_default_active_minus1
    w.ue(0)
    w.u(0, 1)        # weighted_pred
    w.u(0, 2)        # weighted_bipred
    w.se(qp - 26)    # pic_init_qp_minus26
    w.se(0)          # pic_init_qs
    w.se(chroma_qp_offset)
    w.u(0, 1)        # deblocking_filter_control_present
    w.u(0, 1)        # constrained_intra_pred
    w.u(0, 1)        # redundant_pic_cnt_present
    if transform_8x8 or second_chroma_qp_offset is not None \
            or scaling_lists is not None:
        w.u(1 if transform_8x8 else 0, 1)
        if scaling_lists is None:
            w.u(0, 1)
        else:
            w.u(1, 1)
            _write_scaling_lists(w, scaling_lists,
                                 8 if transform_8x8 else 6)
        w.se(second_chroma_qp_offset if second_chroma_qp_offset is not None
             else chroma_qp_offset)
    w.rbsp_trailing()
    return w.to_bytes()


# ---------------------------------------------------------------------------
# CAVLC residual encoding (inverse of spec 9.2)

def _vlc_of(len_tab, code_tab, t1, tc):
    ln = len_tab[t1][tc]
    assert ln > 0, f"invalid coeff_token (tc={tc}, t1={t1})"
    return ln, code_tab[t1][tc]


def encode_residual_cavlc(w: BitWriter, levels_scan, nC: int,
                          max_num_coeff: int) -> int:
    """Encode one residual block; `levels_scan` is the zig-zag-scan-order
    level array (length max_num_coeff).  Returns TotalCoeff."""
    lv = [int(x) for x in levels_scan]
    assert len(lv) == max_num_coeff
    nz = [(i, l) for i, l in enumerate(lv) if l != 0]
    total_coeff = len(nz)
    # levels in decode order: highest frequency first
    rev = [l for _, l in reversed(nz)]
    t1 = 0
    for l in rev[:3]:
        if abs(l) == 1:
            t1 += 1
        else:
            break
    # coeff_token
    if nC >= 8:
        if total_coeff == 0:
            w.u(3, 6)
        else:
            w.u(((total_coeff - 1) << 2) | t1, 6)
    elif nC < 0:
        ln, code = _vlc_of(_CT_CDC_LEN, _CT_CDC_CODE, t1, total_coeff)
        w.u(code, ln)
    else:
        cls = 0 if nC < 2 else (1 if nC < 4 else 2)
        ln, code = _vlc_of(_CT_LEN[cls], _CT_CODE[cls], t1, total_coeff)
        w.u(code, ln)
    if total_coeff == 0:
        return 0

    # trailing one signs
    for i in range(t1):
        w.u(1 if rev[i] < 0 else 0, 1)
    # levels
    suffix_length = 1 if (total_coeff > 10 and t1 < 3) else 0
    for i in range(t1, total_coeff):
        level = rev[i]
        level_code = (abs(level) - 1) * 2 + (1 if level < 0 else 0)
        if i == t1 and t1 < 3:
            level_code -= 2
        if suffix_length == 0:
            if level_code < 14:
                w.u(0, level_code)
                w.u(1, 1)
            elif level_code < 30:
                w.u(0, 14)
                w.u(1, 1)
                w.u(level_code - 14, 4)
            else:
                assert level_code - 30 < 4096, "level too large for fixture"
                w.u(0, 15)
                w.u(1, 1)
                w.u(level_code - 30, 12)
        else:
            if level_code < (15 << suffix_length):
                prefix = level_code >> suffix_length
                w.u(0, prefix)
                w.u(1, 1)
                w.u(level_code & ((1 << suffix_length) - 1), suffix_length)
            else:
                rem = level_code - (15 << suffix_length)
                assert rem < 4096, "level too large for fixture"
                w.u(0, 15)
                w.u(1, 1)
                w.u(rem, 12)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    last_pos = nz[-1][0]
    total_zeros = last_pos + 1 - total_coeff
    if total_coeff < max_num_coeff:
        if max_num_coeff == 4:
            ln = _TZ_CDC_LEN[total_coeff - 1][total_zeros]
            code = _TZ_CDC_CODE[total_coeff - 1][total_zeros]
        else:
            ln = _TZ_LEN[total_coeff - 1][total_zeros]
            code = _TZ_CODE[total_coeff - 1][total_zeros]
        w.u(code, ln)

    # run_before, from highest frequency down
    zeros_left = total_zeros
    positions = [p for p, _ in nz]
    for i in range(total_coeff - 1):
        if zeros_left <= 0:
            break
        hi = positions[-1 - i]
        lo = positions[-2 - i]
        run = hi - lo - 1
        tab = min(zeros_left, 7) - 1
        w.u(_RB_CODE[tab][run], _RB_LEN[tab][run])
        zeros_left -= run
    return total_coeff


# ---------------------------------------------------------------------------
# Macroblock + slice encoding

class FixtureEncoder:
    """Encodes one IDR picture worth of random (but valid) macroblocks."""

    def __init__(self, width_mbs: int, height_mbs: int, rng: np.random.Generator,
                 qp: int = 26, transform_8x8: bool = False,
                 allow_pcm: bool = True, mb_kinds=("i16", "i4"),
                 max_level: int = 6, density: float = 0.3):
        self.wmb = width_mbs
        self.hmb = height_mbs
        self.rng = rng
        self.qp = qp
        self.transform_8x8 = transform_8x8
        self.allow_pcm = allow_pcm
        self.mb_kinds = mb_kinds
        self.max_level = max_level
        self.density = density
        n = width_mbs * height_mbs
        self.total_coeff_luma = np.zeros((n, 16), dtype=np.int16)
        self.total_coeff_chroma = np.zeros((n, 2, 4), dtype=np.int16)
        self.is_pcm = np.zeros(n, dtype=bool)
        self.coded = np.zeros(n, dtype=bool)
        # mirror of the decoder's mode-prediction state
        self.fs = FrameSyntax(width_mbs, height_mbs)
        self.first_mb = 0
        self.resolver = IntraModeResolver(self.fs, 0, False)

    # -- availability of neighbor samples (positional; raster slice order) --

    def _mb_avail(self, mb_addr: int, dx: int, dy: int) -> bool:
        x = mb_addr % self.wmb + dx
        y = mb_addr // self.wmb + dy
        if x < 0 or y < 0 or x >= self.wmb:
            return False
        n = y * self.wmb + x
        return self.first_mb <= n < mb_addr

    def _block_avail(self, mb_addr: int, bx: int, by: int):
        """(left, top, corner) availability for a block at in-MB position
        (bx, by)."""
        al = True if bx > 0 else self._mb_avail(mb_addr, -1, 0)
        at = True if by > 0 else self._mb_avail(mb_addr, 0, -1)
        if bx > 0 and by > 0:
            ac = True
        elif bx == 0 and by > 0:
            ac = self._mb_avail(mb_addr, -1, 0)
        elif by == 0 and bx > 0:
            ac = self._mb_avail(mb_addr, 0, -1)
        else:
            ac = self._mb_avail(mb_addr, -1, -1)
        return al, at, ac

    def _pick_mode(self, mb_addr: int, bx: int, by: int) -> int:
        al, at, ac = self._block_avail(mb_addr, bx, by)
        valid = [m for m, (nl, nt, nc) in _MODE_NEEDS.items()
                 if (not nl or al) and (not nt or at) and (not nc or ac)]
        return int(valid[self.rng.integers(0, len(valid))])

    def _nc(self, mb_addr, blk, chroma_ic, first_mb):
        ns = []
        for which in (A, B):
            if chroma_ic is None:
                mb_n, blk_n = luma4x4_neighbor(mb_addr, blk, which,
                                               self.wmb, first_mb)
            else:
                mb_n, blk_n = chroma4x4_neighbor(mb_addr, blk, which,
                                                 self.wmb, first_mb)
            if mb_n < 0 or not self.coded[mb_n]:
                ns.append(-1)
            elif self.is_pcm[mb_n]:
                ns.append(16)
            elif chroma_ic is None:
                ns.append(int(self.total_coeff_luma[mb_n, blk_n]))
            else:
                ns.append(int(self.total_coeff_chroma[mb_n, chroma_ic, blk_n]))
        na, nb = ns
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        return max(na, nb, 0)

    def _rand_levels(self, n, force_nonzero=False):
        mask = self.rng.random(n) < self.density
        mag = self.rng.integers(1, self.max_level + 1, size=n)
        sign = self.rng.choice((-1, 1), size=n)
        lv = np.where(mask, mag * sign, 0)
        if force_nonzero and not lv.any():
            lv[self.rng.integers(0, n)] = int(self.rng.choice((-1, 1)))
        return lv

    def encode_slice(self, first_mb: int, n_mbs: int, slice_qp_delta: int = 0,
                     idr_pic_id: int = 0, frame_num: int = 0) -> bytes:
        self.first_mb = first_mb
        self.resolver = IntraModeResolver(self.fs, first_mb, False)
        w = BitWriter()
        # slice header (I slice in an IDR NALU)
        w.ue(first_mb)
        w.ue(7)              # slice_type = 7 (I, all-I picture)
        w.ue(0)              # pps id
        w.u(frame_num, 4)    # frame_num (log2_max_frame_num = 4)
        w.ue(idr_pic_id)
        w.u(0, 4)            # pic_order_cnt_lsb (poc type 0, log2 = 4)
        # dec_ref_pic_marking (IDR, ref_idc != 0)
        w.u(0, 1)            # no_output_of_prior_pics
        w.u(0, 1)            # long_term_reference
        w.se(slice_qp_delta)
        qp = self.qp + slice_qp_delta
        for mb_addr in range(first_mb, first_mb + n_mbs):
            qp = self._encode_mb(w, mb_addr, qp, first_mb)
        w.rbsp_trailing()
        return w.to_bytes()

    def _encode_mb(self, w: BitWriter, mb_addr: int, qp_prev: int,
                   first_mb: int) -> int:
        rng = self.rng
        kinds = list(self.mb_kinds)
        if self.allow_pcm and rng.random() < 0.02:
            kind = "pcm"
        else:
            kind = kinds[rng.integers(0, len(kinds))]

        if kind == "pcm":
            w.ue(25)
            w.align_zero()
            for _ in range(256 + 64 + 64):
                w.u(int(rng.integers(0, 256)), 8)
            self.is_pcm[mb_addr] = True
            self.coded[mb_addr] = True
            self.total_coeff_luma[mb_addr, :] = 16
            self.total_coeff_chroma[mb_addr, :, :] = 16
            self.fs.mb_kind[mb_addr] = KIND_IPCM
            self.fs.parsed[mb_addr] = True
            return qp_prev

        if kind == "i16":
            al, at, _ = self._block_avail(mb_addr, 0, 0)
            valid = [2] + ([0] if at else []) + ([1] if al else []) \
                + ([3] if al and at and self._block_avail(mb_addr, 0, 0)[2]
                   else [])
            i16_mode = int(valid[rng.integers(0, len(valid))])
            cbp_c = int(rng.integers(0, 3))
            cbp_l = int(rng.choice((0, 15)))
            mb_type = 1 + i16_mode + 4 * cbp_c + 12 * (cbp_l == 15)
            w.ue(mb_type)
            self.coded[mb_addr] = True
            self.fs.mb_kind[mb_addr] = KIND_I16x16
            self.fs.parsed[mb_addr] = True
            self._encode_chroma_mode(w, mb_addr)
            qp = self._encode_qp_delta(w, qp_prev, always=True)
            # DC block (always present for I16x16)
            nc = self._nc(mb_addr, 0, None, first_mb)
            dc = self._rand_levels(16)
            encode_residual_cavlc(w, dc, nc, 16)
            for blk8 in range(4):
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if cbp_l & (1 << blk8):
                        nc = self._nc(mb_addr, blk, None, first_mb)
                        ac = np.concatenate([[0], self._rand_levels(15)])
                        tc = encode_residual_cavlc(w, ac[1:], nc, 15)
                        self.total_coeff_luma[mb_addr, blk] = tc
            self._encode_chroma_residual(w, mb_addr, cbp_c, first_mb)
            return qp

        if kind == "i8":
            assert self.transform_8x8
            w.ue(0)          # I_NxN
            w.u(1, 1)        # transform_size_8x8_flag
            self.coded[mb_addr] = True
            self.fs.mb_kind[mb_addr] = KIND_I8x8
            self.fs.parsed[mb_addr] = True
            for blk8 in range(4):
                bx, by = (blk8 % 2) * 8, (blk8 // 2) * 8
                target = self._pick_mode(mb_addr, bx, by)
                pred = self.resolver.predicted_8x8_mode(mb_addr, blk8)
                self._encode_pred_mode(w, target, pred)
                self.fs.luma8x8_modes[mb_addr, blk8] = target
            self._encode_chroma_mode(w, mb_addr)
            cbp_l = int(rng.integers(0, 16))
            cbp_c = int(rng.integers(0, 3))
            w.ue(CBP_TO_CODENUM_420[cbp_l | (cbp_c << 4)])
            qp = self._encode_qp_delta(w, qp_prev,
                                       always=bool(cbp_l or cbp_c))
            for blk8 in range(4):
                if not (cbp_l & (1 << blk8)):
                    continue
                lv64 = self._rand_levels(64)
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    sub = lv64[np.arange(16) * 4 + i4]
                    nc = self._nc(mb_addr, blk, None, first_mb)
                    tc = encode_residual_cavlc(w, sub, nc, 16)
                    self.total_coeff_luma[mb_addr, blk] = tc
            self._encode_chroma_residual(w, mb_addr, cbp_c, first_mb)
            return qp

        # i4
        w.ue(0)              # I_NxN
        if self.transform_8x8:
            w.u(0, 1)
        self.coded[mb_addr] = True
        self.fs.mb_kind[mb_addr] = KIND_I4x4
        self.fs.parsed[mb_addr] = True
        for blk in range(16):
            bx, by = int(BLK4x4_POS[blk][0]), int(BLK4x4_POS[blk][1])
            target = self._pick_mode(mb_addr, bx, by)
            pred = self.resolver.predicted_4x4_mode(mb_addr, blk)
            self._encode_pred_mode(w, target, pred)
            self.fs.luma4x4_modes[mb_addr, blk] = target
        self._encode_chroma_mode(w, mb_addr)
        cbp_l = int(rng.integers(0, 16))
        cbp_c = int(rng.integers(0, 3))
        w.ue(CBP_TO_CODENUM_420[cbp_l | (cbp_c << 4)])
        qp = self._encode_qp_delta(w, qp_prev, always=bool(cbp_l or cbp_c))
        for blk8 in range(4):
            for i4 in range(4):
                blk = blk8 * 4 + i4
                if cbp_l & (1 << blk8):
                    nc = self._nc(mb_addr, blk, None, first_mb)
                    lv = self._rand_levels(16)
                    tc = encode_residual_cavlc(w, lv, nc, 16)
                    self.total_coeff_luma[mb_addr, blk] = tc
        self._encode_chroma_residual(w, mb_addr, cbp_c, first_mb)
        return qp

    def _encode_pred_mode(self, w: BitWriter, target: int,
                          predicted: int) -> None:
        if target == predicted:
            w.u(1, 1)        # prev_intra_pred_mode_flag
        else:
            w.u(0, 1)
            rem = target if target < predicted else target - 1
            w.u(rem, 3)

    def _encode_chroma_mode(self, w: BitWriter, mb_addr: int) -> None:
        # chroma modes: 0 DC (always valid), 1 H (left), 2 V (top), 3 plane
        al = self._mb_avail(mb_addr, -1, 0)
        at = self._mb_avail(mb_addr, 0, -1)
        valid = [0] + ([1] if al else []) + ([2] if at else []) \
            + ([3] if al and at and self._mb_avail(mb_addr, -1, -1) else [])
        w.ue(int(valid[self.rng.integers(0, len(valid))]))

    def _encode_qp_delta(self, w: BitWriter, qp_prev: int,
                         always: bool) -> int:
        if not always:
            return qp_prev
        # avoid QP drifting to exactly 36: the reference's Intra16x16 DC
        # scaling hits C undefined behavior there (`if (qP > 36)` instead
        # of the spec's >= 36, h264_transform.c:797) and golden comparison
        # would be against garbage
        while True:
            delta = int(self.rng.integers(-4, 5))
            new_qp = (qp_prev + delta + 52) % 52
            if new_qp != 36:
                break
        w.se(delta)
        return new_qp

    def _encode_chroma_residual(self, w: BitWriter, mb_addr: int,
                                cbp_c: int, first_mb: int) -> None:
        if cbp_c:
            for _ic in range(2):
                dc = self._rand_levels(4)
                encode_residual_cavlc(w, dc, -1, 4)
        if cbp_c & 2:
            for ic in range(2):
                for blk in range(4):
                    nc = self._nc(mb_addr, blk, ic, first_mb)
                    ac = self._rand_levels(15)
                    tc = encode_residual_cavlc(w, ac, nc, 15)
                    self.total_coeff_chroma[mb_addr, ic, blk] = tc


def make_stream(width_mbs=4, height_mbs=3, n_pictures=1, seed=0, qp=26,
                profile=66, transform_8x8=False, mb_kinds=("i16", "i4"),
                allow_pcm=True, n_slices=1, scaling_lists=None,
                pps_scaling_lists=None, max_level=6, density=0.3,
                crop=(0, 0, 0, 0)) -> bytes:
    """Build a complete Annex-B stream: SPS + PPS + n IDR pictures."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    out += nalu(7, encode_sps(width_mbs, height_mbs, profile=profile,
                              scaling_lists=scaling_lists, crop=crop))
    out += nalu(8, encode_pps(qp=qp, transform_8x8=transform_8x8,
                              scaling_lists=pps_scaling_lists))
    n_mbs = width_mbs * height_mbs
    for pic in range(n_pictures):
        enc = FixtureEncoder(width_mbs, height_mbs, rng, qp=qp,
                             transform_8x8=transform_8x8,
                             mb_kinds=mb_kinds, allow_pcm=allow_pcm,
                             max_level=max_level, density=density)
        per_slice = (n_mbs + n_slices - 1) // n_slices
        first = 0
        while first < n_mbs:
            cnt = min(per_slice, n_mbs - first)
            rbsp = enc.encode_slice(first, cnt, idr_pic_id=pic % 8,
                                    frame_num=0)
            out += nalu(5, rbsp)
            first += cnt
    # trailing filler NALU: the reference's ES scanner stops its start-code
    # search 32 bytes before EOF (esparser.c:65) and would otherwise drop a
    # short final sample
    out += nalu(12, b"\xff" * 40, ref_idc=0)
    return bytes(out)


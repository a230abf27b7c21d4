"""Plan-based H.264 intra fixture encoder: CAVLC *and* CABAC emitters.

Copy of tests/fixtures/h264enc2.py wired to the port's own modules, so the
port can make CABAC streams on a machine without the JAX package: the same
arguments give the same bytes (tests/test_torch_isolation.py checks it).

The macroblock decisions (kinds, modes, CBPs, QP deltas, residual levels)
are drawn once into per-MB "plans"; the same plans can then be emitted
with either entropy coder.  Decoding both streams must therefore yield
bit-identical pictures — a strong cross-coder validation that does not
depend on the (buggy per its own README) reference CABAC.
"""

from __future__ import annotations

import numpy as np

from ..models.h264.cabac import ContextDeriv, _CAT_OFF_CBF
from ..models.h264.cabac import (CAT_CHROMA_AC, CAT_CHROMA_DC,
                                 CAT_LUMA_4x4, CAT_LUMA_8x8, CAT_LUMA_AC,
                                 CAT_LUMA_DC, _BASE_ABS, _BASE_ABS8,
                                 _BASE_LAST, _BASE_LAST8, _BASE_SIG,
                                 _BASE_SIG8, _CAT_OFF_ABS, _CAT_OFF_LAST,
                                 _CAT_OFF_SIG, _clip3)
from ..models.h264.cabac_tables import (CONTEXT_INIT_I, LAST8x8,
                                        RANGE_TAB_LPS, SIG8x8_FRAME,
                                        TRANS_IDX_LPS, TRANS_IDX_MPS)
from ..models.h264.spatial import (A, B, chroma4x4_neighbor,
                                   luma4x4_neighbor)
from ..models.h264.syntax import (FrameSyntax, IntraModeResolver,
                                  KIND_I4x4, KIND_I8x8, KIND_I16x16,
                                  KIND_IPCM)
from ..models.h264.tables import BLK4x4_POS
from .h264enc import (BitWriter, CBP_TO_CODENUM_420, _MODE_NEEDS,
                      encode_pps, encode_residual_cavlc, encode_sps, nalu)


# ---------------------------------------------------------------------------
# planning


def _mb_avail(wmb, hmb, first_mb, mb_addr, dx, dy):
    x = mb_addr % wmb + dx
    y = mb_addr // wmb + dy
    if x < 0 or y < 0 or x >= wmb:
        return False
    n = y * wmb + x
    return first_mb <= n < mb_addr


def _block_avail(wmb, hmb, first_mb, mb_addr, bx, by):
    al = True if bx > 0 else _mb_avail(wmb, hmb, first_mb, mb_addr, -1, 0)
    at = True if by > 0 else _mb_avail(wmb, hmb, first_mb, mb_addr, 0, -1)
    if bx > 0 and by > 0:
        ac = True
    elif bx == 0 and by > 0:
        ac = _mb_avail(wmb, hmb, first_mb, mb_addr, -1, 0)
    elif by == 0 and bx > 0:
        ac = _mb_avail(wmb, hmb, first_mb, mb_addr, 0, -1)
    else:
        ac = _mb_avail(wmb, hmb, first_mb, mb_addr, -1, -1)
    return al, at, ac


def _rand_levels(rng, n, density, max_level):
    mask = rng.random(n) < density
    mag = rng.integers(1, max_level + 1, size=n)
    sign = rng.choice((-1, 1), size=n)
    return [int(v) for v in np.where(mask, mag * sign, 0)]


def plan_frame(wmb, hmb, rng, slices, qp, mb_kinds=("i16", "i4"),
               allow_pcm=False, transform_8x8=False, density=0.3,
               max_level=6):
    """Returns list of per-slice lists of MB plan dicts."""
    n_mbs = wmb * hmb
    per_slice = (n_mbs + slices - 1) // slices
    out = []
    first = 0
    while first < n_mbs:
        cnt = min(per_slice, n_mbs - first)
        plans = []
        qp_run = qp          # QPYprev resets to the slice QP per slice
        for mb_addr in range(first, first + cnt):
            kinds = list(mb_kinds)
            if allow_pcm and rng.random() < 0.03:
                kind = "pcm"
            else:
                kind = kinds[rng.integers(0, len(kinds))]
            p = {"kind": kind, "addr": mb_addr}
            if kind == "pcm":
                p["pcm"] = bytes(rng.integers(0, 256, 384,
                                              dtype=np.uint8))
                plans.append(p)
                continue
            def pick(bx, by):
                al, at, ac = _block_avail(wmb, hmb, first, mb_addr, bx, by)
                valid = [m for m, (nl, nt, nc) in _MODE_NEEDS.items()
                         if (not nl or al) and (not nt or at)
                         and (not nc or ac)]
                return int(valid[rng.integers(0, len(valid))])

            al, at, ac = _block_avail(wmb, hmb, first, mb_addr, 0, 0)
            cvalid = [0] + ([1] if al else []) + ([2] if at else []) \
                + ([3] if al and at and ac else [])
            p["chroma_mode"] = int(cvalid[rng.integers(0, len(cvalid))])
            p["cbp_c"] = int(rng.integers(0, 3))

            if kind == "i16":
                ivalid = [2] + ([0] if at else []) + ([1] if al else []) \
                    + ([3] if al and at and ac else [])
                p["i16_mode"] = int(ivalid[rng.integers(0, len(ivalid))])
                p["cbp_l"] = int(rng.choice((0, 15)))
                p["dc16"] = _rand_levels(rng, 16, density, max_level)
                p["ac"] = [_rand_levels(rng, 15, density, max_level)
                           if p["cbp_l"] else [0] * 15 for _ in range(16)]
            elif kind == "i8":
                p["modes8"] = [pick((i % 2) * 8, (i // 2) * 8)
                               for i in range(4)]
                p["cbp_l"] = int(rng.integers(0, 16))
                p["lv64"] = [_rand_levels(rng, 64, density, max_level)
                             if (p["cbp_l"] >> i) & 1 else [0] * 64
                             for i in range(4)]
            else:
                p["modes4"] = [pick(int(BLK4x4_POS[b][0]),
                                    int(BLK4x4_POS[b][1]))
                               for b in range(16)]
                p["cbp_l"] = int(rng.integers(0, 16))
                p["lv16"] = [_rand_levels(rng, 16, density, max_level)
                             if (p["cbp_l"] >> (b // 4)) & 1 else [0] * 16
                             for b in range(16)]
            p["cdc"] = [_rand_levels(rng, 4, density, max_level)
                        if p["cbp_c"] else [0] * 4 for _ in range(2)]
            p["cac"] = [[_rand_levels(rng, 15, density, max_level)
                         if p["cbp_c"] == 2 else [0] * 15
                         for _ in range(4)] for _ in range(2)]
            # qp delta, tracking the RUNNING QPY so no MB lands on 36
            # (reference UB in Intra16x16 DC scaling, see h264enc.py
            # _encode_qp_delta); only drawn when the delta is actually
            # emitted (I16x16, or CBP nonzero)
            if kind == "i16" or p["cbp_l"] or p["cbp_c"]:
                while True:
                    delta = int(rng.integers(-4, 5))
                    if (qp_run + delta + 52) % 52 != 36:
                        break
                p["qp_delta"] = delta
                qp_run = (qp_run + delta + 52) % 52
            else:
                p["qp_delta"] = 0
            plans.append(p)
        out.append(plans)
        first += cnt
    return out


# ---------------------------------------------------------------------------
# slice header (shared)


def _slice_header_bits(w, first_mb, idr_pic_id, frame_num):
    w.ue(first_mb)
    w.ue(7)              # slice_type I
    w.ue(0)              # pps id
    w.u(frame_num, 4)
    w.ue(idr_pic_id)
    w.u(0, 4)            # pic_order_cnt_lsb
    w.u(0, 1)            # no_output_of_prior_pics
    w.u(0, 1)            # long_term_reference
    w.se(0)              # slice_qp_delta


# ---------------------------------------------------------------------------
# CAVLC emitter


def emit_cavlc_slice(plans, wmb, hmb, fs, qp, first_mb, idr_pic_id=0,
                     transform_8x8=False):
    w = BitWriter()
    _slice_header_bits(w, first_mb, idr_pic_id, 0)
    resolver = IntraModeResolver(fs, first_mb, False)
    tc_luma = fs.total_coeff_luma
    tc_chroma = fs.total_coeff_chroma
    qp_prev = qp

    def nc(mb_addr, blk, icbcr=None):
        ns = []
        for which in (A, B):
            if icbcr is None:
                mb_n, blk_n = luma4x4_neighbor(mb_addr, blk, which, wmb,
                                               first_mb)
            else:
                mb_n, blk_n = chroma4x4_neighbor(mb_addr, blk, which, wmb,
                                                 first_mb)
            if mb_n < 0 or not fs.parsed[mb_n]:
                ns.append(-1)
            elif fs.mb_kind[mb_n] == KIND_IPCM:
                ns.append(16)
            elif icbcr is None:
                ns.append(int(tc_luma[mb_n, blk_n]))
            else:
                ns.append(int(tc_chroma[mb_n, icbcr, blk_n]))
        na, nb = ns
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        return max(na, nb, 0)

    for p in plans:
        mb_addr = p["addr"]
        if p["kind"] == "pcm":
            w.ue(25)
            w.align_zero()
            for byte in p["pcm"]:
                w.u(byte, 8)
            _apply_pcm(fs, mb_addr, p)
            continue
        if p["kind"] == "i16":
            mb_type = 1 + p["i16_mode"] + 4 * p["cbp_c"] \
                + (12 if p["cbp_l"] else 0)
            w.ue(mb_type)
            _apply_i16(fs, mb_addr, p)
            w.ue(p["chroma_mode"])
            w.se(p["qp_delta"])
            qp_prev = (qp_prev + p["qp_delta"] + 52) % 52
            encode_residual_cavlc(w, p["dc16"], nc(mb_addr, 0), 16)
            for blk8 in range(4):
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if p["cbp_l"] & (1 << blk8):
                        tc = encode_residual_cavlc(
                            w, p["ac"][blk], nc(mb_addr, blk), 15)
                        tc_luma[mb_addr, blk] = tc
        elif p["kind"] == "i8":
            w.ue(0)
            w.u(1, 1)
            fs.mb_kind[mb_addr] = KIND_I8x8
            fs.transform8x8[mb_addr] = 1
            fs.parsed[mb_addr] = True
            for blk8 in range(4):
                pred = resolver.predicted_8x8_mode(mb_addr, blk8)
                _emit_pred_mode_cavlc(w, p["modes8"][blk8], pred)
                fs.luma8x8_modes[mb_addr, blk8] = p["modes8"][blk8]
            w.ue(p["chroma_mode"])
            w.ue(CBP_TO_CODENUM_420[p["cbp_l"] | (p["cbp_c"] << 4)])
            if p["cbp_l"] or p["cbp_c"]:
                w.se(p["qp_delta"])
                qp_prev = (qp_prev + p["qp_delta"] + 52) % 52
            for blk8 in range(4):
                if not (p["cbp_l"] >> blk8) & 1:
                    continue
                lv64 = p["lv64"][blk8]
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    sub = [lv64[4 * k + i4] for k in range(16)]
                    tc = encode_residual_cavlc(
                        w, sub, nc(mb_addr, blk), 16)
                    tc_luma[mb_addr, blk] = tc
        else:
            w.ue(0)
            if transform_8x8:
                w.u(0, 1)
            fs.mb_kind[mb_addr] = KIND_I4x4
            fs.parsed[mb_addr] = True
            for blk in range(16):
                pred = resolver.predicted_4x4_mode(mb_addr, blk)
                _emit_pred_mode_cavlc(w, p["modes4"][blk], pred)
                fs.luma4x4_modes[mb_addr, blk] = p["modes4"][blk]
            w.ue(p["chroma_mode"])
            w.ue(CBP_TO_CODENUM_420[p["cbp_l"] | (p["cbp_c"] << 4)])
            if p["cbp_l"] or p["cbp_c"]:
                w.se(p["qp_delta"])
                qp_prev = (qp_prev + p["qp_delta"] + 52) % 52
            for blk8 in range(4):
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if (p["cbp_l"] >> blk8) & 1:
                        tc = encode_residual_cavlc(
                            w, p["lv16"][blk], nc(mb_addr, blk), 16)
                        tc_luma[mb_addr, blk] = tc
        fs.chroma_mode[mb_addr] = p["chroma_mode"]
        fs.cbp_luma[mb_addr] = p["cbp_l"]
        fs.cbp_chroma[mb_addr] = p["cbp_c"]
        if p["cbp_c"]:
            for ic in range(2):
                encode_residual_cavlc(w, p["cdc"][ic], -1, 4)
        if p["cbp_c"] & 2:
            for ic in range(2):
                for blk in range(4):
                    tc = encode_residual_cavlc(
                        w, p["cac"][ic][blk], nc(mb_addr, blk, ic), 15)
                    tc_chroma[mb_addr, ic, blk] = tc
    w.rbsp_trailing()
    return w.to_bytes()


def _emit_pred_mode_cavlc(w, target, pred):
    if target == pred:
        w.u(1, 1)
    else:
        w.u(0, 1)
        w.u(target if target < pred else target - 1, 3)


def _apply_pcm(fs, mb_addr, p):
    raw = np.frombuffer(p["pcm"], dtype=np.uint8)
    fs.mb_kind[mb_addr] = KIND_IPCM
    fs.parsed[mb_addr] = True
    fs.pcm_y[mb_addr] = raw[:256].reshape(16, 16).copy()
    fs.pcm_cb[mb_addr] = raw[256:320].reshape(8, 8).copy()
    fs.pcm_cr[mb_addr] = raw[320:].reshape(8, 8).copy()
    fs.total_coeff_luma[mb_addr, :] = 16
    fs.total_coeff_chroma[mb_addr, :, :] = 16
    fs.cbf_luma[mb_addr, :] = 1
    fs.cbf_luma8x8[mb_addr, :] = 1
    fs.cbf_luma_dc[mb_addr] = 1
    fs.cbf_chroma_dc[mb_addr, :] = 1
    fs.cbf_chroma[mb_addr, :, :] = 1


def _apply_i16(fs, mb_addr, p):
    fs.mb_kind[mb_addr] = KIND_I16x16
    fs.parsed[mb_addr] = True
    fs.i16_mode[mb_addr] = p["i16_mode"]


# ---------------------------------------------------------------------------
# CABAC encoding engine (spec 9.3.4)


class CabacEncoder:
    def __init__(self, w: BitWriter, slice_qp: int):
        self.w = w
        self.state = np.zeros(460, dtype=np.int32)
        self.mps = np.zeros(460, dtype=np.int32)
        qp = _clip3(0, 51, slice_qp)
        for i, (m, n) in enumerate(CONTEXT_INIT_I):
            pre = _clip3(1, 126, ((m * qp) >> 4) + n)
            if pre <= 63:
                self.state[i] = 63 - pre
                self.mps[i] = 0
            else:
                self.state[i] = pre - 64
                self.mps[i] = 1
        self._reset_arith()

    def _reset_arith(self):
        self.low = 0
        self.range = 510
        self.first_bit = True
        self.outstanding = 0

    def _put(self, b):
        if self.first_bit:
            self.first_bit = False
        else:
            self.w.u(b, 1)
        while self.outstanding > 0:
            self.w.u(1 - b, 1)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, b):
        st = int(self.state[ctx])
        q = (self.range >> 6) & 3
        r_lps = RANGE_TAB_LPS[st][q]
        self.range -= r_lps
        if b != int(self.mps[ctx]):
            self.low += self.range
            self.range = r_lps
            if st == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = TRANS_IDX_LPS[st]
        else:
            self.state[ctx] = TRANS_IDX_MPS[st]
        self._renorm()

    def bypass(self, b):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def terminate(self, b):
        self.range -= 2
        if b:
            self.low += self.range
            self.flush()
        else:
            self._renorm()

    def flush(self):
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.w.u(((self.low >> 7) & 3) | 1, 2)


# ---------------------------------------------------------------------------
# CABAC emitter


class CabacEmitter(ContextDeriv):
    def __init__(self, w, wmb, hmb, fs, qp, first_mb):
        super().__init__(fs, first_mb)
        self.w = w
        self.wmb = wmb
        self.qp_prev = qp
        self.prev_qp_delta = 0
        self.enc = CabacEncoder(w, qp)
        self.resolver = IntraModeResolver(fs, first_mb, False)

    def _mb_type(self, mb_addr, mb_type):
        e = self.enc
        inc = self._cond_mbtype(mb_addr)
        if mb_type == 0:
            e.decision(3 + inc, 0)
            return
        e.decision(3 + inc, 1)
        if mb_type == 25:
            e.terminate(1)
            return
        e.terminate(0)
        t = mb_type - 1
        pred = t % 4
        cbp_c = (t // 4) % 3
        cbp_l = 1 if t >= 12 else 0
        e.decision(3 + 3, cbp_l)
        if cbp_c == 0:
            e.decision(3 + 4, 0)
        else:
            e.decision(3 + 4, 1)
            e.decision(3 + 5, 1 if cbp_c == 2 else 0)
        e.decision(3 + 6, (pred >> 1) & 1)
        e.decision(3 + 7, pred & 1)

    def _pred_mode(self, target, pred):
        e = self.enc
        if target == pred:
            e.decision(68, 1)
        else:
            e.decision(68, 0)
            rem = target if target < pred else target - 1
            e.decision(69, rem & 1)
            e.decision(69, (rem >> 1) & 1)
            e.decision(69, (rem >> 2) & 1)

    def _chroma_mode(self, mb_addr, mode):
        e = self.enc
        inc = self._cond_chroma_pred(mb_addr)
        if mode == 0:
            e.decision(64 + inc, 0)
            return
        e.decision(64 + inc, 1)
        if mode == 1:
            e.decision(67, 0)
            return
        e.decision(67, 1)
        e.decision(67, 1 if mode == 3 else 0)

    def _cbp(self, mb_addr, cbp_l, cbp_c):
        e = self.enc
        partial = 0
        for blk8 in range(4):
            self.fs.cbp_luma[mb_addr] = partial
            inc = self._cond_cbp_luma(mb_addr, blk8)
            bit = (cbp_l >> blk8) & 1
            e.decision(73 + inc, bit)
            partial |= bit << blk8
        self.fs.cbp_luma[mb_addr] = cbp_l
        if cbp_c == 0:
            e.decision(77 + self._cond_cbp_chroma(mb_addr, 0), 0)
        else:
            e.decision(77 + self._cond_cbp_chroma(mb_addr, 0), 1)
            e.decision(81 + self._cond_cbp_chroma(mb_addr, 1),
                       1 if cbp_c == 2 else 0)

    def _qp_delta(self, delta):
        e = self.enc
        code = 2 * delta - 1 if delta > 0 else -2 * delta
        inc = 1 if self.prev_qp_delta != 0 else 0
        if code == 0:
            e.decision(60 + inc, 0)
        else:
            e.decision(60 + inc, 1)
            if code == 1:
                e.decision(62, 0)
            else:
                e.decision(62, 1)
                for _ in range(code - 2):
                    e.decision(63, 1)
                e.decision(63, 0)
        self.prev_qp_delta = delta
        self.qp_prev = (self.qp_prev + delta + 52) % 52

    def _residual(self, mb_addr, cat, blk, levels, max_coeff):
        """Encode one residual block; returns cbf."""
        e = self.enc
        nz = [i for i, v in enumerate(levels) if v]
        cbf = 1 if nz else 0
        if cat != CAT_LUMA_8x8:
            inc = self._cond_cbf(mb_addr, cat, blk)
            e.decision(85 + _CAT_OFF_CBF[cat] + inc, cbf)
            if not cbf:
                return 0
        num_coeff = nz[-1] + 1 if nz else 0
        if cat == CAT_LUMA_8x8:
            assert cbf, "cat-5 blocks must carry coefficients"
            sig_base = _BASE_SIG8
            last_base = _BASE_LAST8
        else:
            sig_base = _BASE_SIG + _CAT_OFF_SIG[cat]
            last_base = _BASE_LAST + _CAT_OFF_LAST[cat]
        for i in range(min(num_coeff, max_coeff - 1)):
            if cat == CAT_LUMA_8x8:
                sig_inc, last_inc = SIG8x8_FRAME[i], LAST8x8[i]
            elif cat == CAT_CHROMA_DC:
                sig_inc = last_inc = min(i, 2)
            else:
                sig_inc = last_inc = i
            sig = 1 if levels[i] else 0
            e.decision(sig_base + sig_inc, sig)
            if sig:
                e.decision(last_base + last_inc,
                           1 if i == num_coeff - 1 else 0)
        if cat == CAT_LUMA_8x8:
            abs_base = _BASE_ABS8
        else:
            abs_base = _BASE_ABS + _CAT_OFF_ABS[cat]
        num_gt1 = num_eq1 = 0
        for idx in reversed(nz):
            level = levels[idx]
            mag = abs(level)
            inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            cap = 3 if cat == CAT_CHROMA_DC else 4
            inc_n = 5 + min(cap, num_gt1)
            prefix = min(mag - 1, 14)
            if prefix == 0:
                e.decision(abs_base + inc0, 0)
            else:
                e.decision(abs_base + inc0, 1)
                for _ in range(prefix - 1):
                    e.decision(abs_base + inc_n, 1)
                if prefix < 14:
                    e.decision(abs_base + inc_n, 0)
            if prefix == 14:
                # EG0 suffix in bypass
                rem = mag - 15
                k = 0
                while rem >= (1 << (k + 1)) - 1:
                    k += 1
                for _ in range(k):
                    e.bypass(1)
                e.bypass(0)
                payload = rem - ((1 << k) - 1)
                for bitpos in range(k - 1, -1, -1):
                    e.bypass((payload >> bitpos) & 1)
            if mag == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            e.bypass(1 if level < 0 else 0)
        return 1


def emit_cabac_slice(plans, wmb, hmb, fs, qp, first_mb, idr_pic_id=0,
                     transform_8x8=False):
    w = BitWriter()
    _slice_header_bits(w, first_mb, idr_pic_id, 0)
    # cabac_alignment_one_bit
    while len(w.bits) % 8:
        w.u(1, 1)
    em = CabacEmitter(w, wmb, hmb, fs, qp, first_mb)
    e = em.enc

    for p in plans:
        mb_addr = p["addr"]
        if p["kind"] == "pcm":
            em._mb_type(mb_addr, 25)          # includes terminate+flush
            w.align_zero()
            for byte in p["pcm"]:
                w.u(byte, 8)
            _apply_pcm(fs, mb_addr, p)
            em.prev_qp_delta = 0
            e._reset_arith()
            e.terminate(1 if p is plans[-1] else 0)   # end_of_slice_flag
            continue
        if p["kind"] == "i16":
            mb_type = 1 + p["i16_mode"] + 4 * p["cbp_c"] \
                + (12 if p["cbp_l"] else 0)
            em._mb_type(mb_addr, mb_type)
            _apply_i16(fs, mb_addr, p)
            fs.cbp_luma[mb_addr] = p["cbp_l"]
            fs.cbp_chroma[mb_addr] = p["cbp_c"]
            em._chroma_mode(mb_addr, p["chroma_mode"])
            fs.chroma_mode[mb_addr] = p["chroma_mode"]
            em._qp_delta(p["qp_delta"])
            fs.cbf_luma_dc[mb_addr] = em._residual(
                mb_addr, CAT_LUMA_DC, 0, p["dc16"], 16)
            for blk8 in range(4):
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if p["cbp_l"] & (1 << blk8):
                        fs.cbf_luma[mb_addr, blk] = em._residual(
                            mb_addr, CAT_LUMA_AC, blk, p["ac"][blk], 15)
        elif p["kind"] == "i8":
            em._mb_type(mb_addr, 0)
            e.decision(399 + em._cond_transform8x8(mb_addr), 1)
            fs.mb_kind[mb_addr] = KIND_I8x8
            fs.transform8x8[mb_addr] = 1
            fs.parsed[mb_addr] = True
            for blk8 in range(4):
                pred = em.resolver.predicted_8x8_mode(mb_addr, blk8)
                em._pred_mode(p["modes8"][blk8], pred)
                fs.luma8x8_modes[mb_addr, blk8] = p["modes8"][blk8]
            em._chroma_mode(mb_addr, p["chroma_mode"])
            fs.chroma_mode[mb_addr] = p["chroma_mode"]
            em._cbp(mb_addr, p["cbp_l"], p["cbp_c"])
            fs.cbp_chroma[mb_addr] = p["cbp_c"]
            if p["cbp_l"] or p["cbp_c"]:
                em._qp_delta(p["qp_delta"])
            else:
                em.prev_qp_delta = 0
            for blk8 in range(4):
                if (p["cbp_l"] >> blk8) & 1:
                    em._residual(mb_addr, CAT_LUMA_8x8, blk8,
                                 p["lv64"][blk8], 64)
                    fs.cbf_luma8x8[mb_addr, blk8] = 1
        else:
            em._mb_type(mb_addr, 0)
            if transform_8x8:
                e.decision(399 + em._cond_transform8x8(mb_addr), 0)
            fs.mb_kind[mb_addr] = KIND_I4x4
            fs.parsed[mb_addr] = True
            for blk in range(16):
                pred = em.resolver.predicted_4x4_mode(mb_addr, blk)
                em._pred_mode(p["modes4"][blk], pred)
                fs.luma4x4_modes[mb_addr, blk] = p["modes4"][blk]
            em._chroma_mode(mb_addr, p["chroma_mode"])
            fs.chroma_mode[mb_addr] = p["chroma_mode"]
            em._cbp(mb_addr, p["cbp_l"], p["cbp_c"])
            fs.cbp_chroma[mb_addr] = p["cbp_c"]
            if p["cbp_l"] or p["cbp_c"]:
                em._qp_delta(p["qp_delta"])
            else:
                em.prev_qp_delta = 0
            for blk8 in range(4):
                for i4 in range(4):
                    blk = blk8 * 4 + i4
                    if (p["cbp_l"] >> blk8) & 1:
                        fs.cbf_luma[mb_addr, blk] = em._residual(
                            mb_addr, CAT_LUMA_4x4, blk, p["lv16"][blk], 16)
        if p["cbp_c"]:
            for ic in range(2):
                fs.cbf_chroma_dc[mb_addr, ic] = em._residual(
                    mb_addr, CAT_CHROMA_DC, ic, p["cdc"][ic], 4)
        if p["cbp_c"] & 2:
            for ic in range(2):
                for blk in range(4):
                    fs.cbf_chroma[mb_addr, ic, blk] = em._residual(
                        mb_addr, CAT_CHROMA_AC, (ic, blk),
                        p["cac"][ic][blk], 15)
        is_last = p is plans[-1]
        e.terminate(1 if is_last else 0)

    # flush happened inside terminate(1); pad to byte with zeros (the
    # flush's trailing '1' doubles as the rbsp stop bit, spec 9.3.4.4)
    w.align_zero()
    return w.to_bytes()


def make_stream2(width_mbs=4, height_mbs=3, n_pictures=1, seed=0, qp=26,
                 entropy="cavlc", mb_kinds=("i16", "i4"), allow_pcm=False,
                 transform_8x8=False, n_slices=1, density=0.3,
                 max_level=6):
    """Build a complete Annex-B stream with either entropy coder.

    The same seed yields identical macroblock plans for both coders, so
    decoded pictures must match bit-exactly across entropy modes."""
    rng = np.random.default_rng(seed)
    cabac = entropy == "cabac"
    profile = 100 if (transform_8x8 or "i8" in mb_kinds or cabac) else 66
    out = bytearray()
    out += nalu(7, encode_sps(width_mbs, height_mbs, profile=profile))
    # Always emit the PPS extension for High-profile streams: the
    # reference decoder reads transform_8x8_mode_flag /
    # second_chroma_qp_index_offset as uninitialized memory when the
    # extension is absent (decodePPS never applies the spec defaults),
    # which makes golden comparisons nondeterministic.
    out += nalu(8, encode_pps(qp=qp, entropy_cabac=cabac,
                              transform_8x8=transform_8x8,
                              second_chroma_qp_offset=(
                                  0 if profile == 100 else None)))
    for pic in range(n_pictures):
        sliced = plan_frame(width_mbs, height_mbs, rng, n_slices, qp,
                            mb_kinds=mb_kinds, allow_pcm=allow_pcm,
                            transform_8x8=transform_8x8, density=density,
                            max_level=max_level)
        fs = FrameSyntax(width_mbs, height_mbs)
        first = 0
        for plans in sliced:
            if cabac:
                rbsp = emit_cabac_slice(plans, width_mbs, height_mbs, fs,
                                        qp, first, idr_pic_id=pic % 8,
                                        transform_8x8=transform_8x8)
            else:
                rbsp = emit_cavlc_slice(plans, width_mbs, height_mbs, fs,
                                        qp, first, idr_pic_id=pic % 8,
                                        transform_8x8=transform_8x8)
            out += nalu(5, rbsp)
            first += len(plans)
    out += nalu(12, b"\xff" * 40, ref_idc=0)
    return bytes(out)

"""CAVLC residual block decoding (ITU-T H.264 clause 9.2).

Reference: minivideo/src/decoder/h264/h264_cavlc.c (residual_block_cavlc
:79-365) and h264_cavlc_tables.h.  Tables below are the standard's VLC
code tables expressed as (code_length, code_value) pairs:
 - COEFF_TOKEN_*: Table 9-5, per nC class
 - TOTAL_ZEROS_*: Tables 9-7/9-8 (4x4), Table 9-9(a) (chroma DC 4:2:0)
 - RUN_BEFORE: Table 9-10
Every conforming codec carries identical values.  Each table is validated
as a prefix code at import time.
"""

from __future__ import annotations

from .bitio import BitReader, BitstreamError

# ----------------------------------------------------------------------------
# Table 9-5 coeff_token, classes 0<=nC<2, 2<=nC<4, 4<=nC<8.
# Layout: LEN[t1][tc_index], CODE[t1][tc_index] where tc_index = TotalCoeff
# and t1 = TrailingOnes; length 0 = invalid combination.
_CT_LEN = (
    # 0 <= nC < 2
    ((1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16),
     (0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16),
     (0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16),
     (0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16)),
    # 2 <= nC < 4
    ((2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14),
     (0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14),
     (0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14),
     (0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14)),
    # 4 <= nC < 8
    ((4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10),
     (0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10),
     (0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10),
     (0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10)),
)

_CT_CODE = (
    ((1, 5, 7, 7, 7, 7, 15, 11, 8, 15, 11, 15, 11, 15, 11, 7, 4),
     (0, 1, 4, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 1, 14, 10, 6),
     (0, 0, 1, 5, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 13, 9, 5),
     (0, 0, 0, 3, 3, 4, 4, 4, 4, 4, 12, 12, 8, 12, 8, 12, 8)),
    ((3, 11, 7, 7, 7, 4, 7, 15, 11, 15, 11, 8, 15, 11, 7, 9, 7),
     (0, 2, 7, 10, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 11, 8, 6),
     (0, 0, 3, 9, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 6, 10, 5),
     (0, 0, 0, 5, 4, 6, 8, 4, 4, 4, 12, 8, 12, 12, 8, 1, 4)),
    ((15, 15, 11, 8, 15, 11, 9, 8, 15, 11, 15, 11, 8, 13, 9, 5, 1),
     (0, 14, 15, 12, 10, 8, 14, 10, 14, 14, 10, 14, 10, 7, 12, 8, 4),
     (0, 0, 13, 14, 11, 9, 13, 9, 13, 10, 13, 9, 13, 9, 11, 7, 3),
     (0, 0, 0, 12, 11, 10, 9, 8, 13, 12, 12, 12, 8, 12, 10, 6, 2)),
)

# Table 9-5, nC == -1 (chroma DC, 4:2:0): indexed likewise, TotalCoeff 0..4.
_CT_CDC_LEN = ((2, 6, 6, 6, 6),
               (0, 1, 6, 7, 8),
               (0, 0, 3, 7, 8),
               (0, 0, 0, 6, 7))
_CT_CDC_CODE = ((1, 7, 4, 3, 2),
                (0, 1, 6, 3, 3),
                (0, 0, 1, 2, 2),
                (0, 0, 0, 5, 0))


def _build_prefix_map(len_tab, code_tab, payload_fn):
    """(len,code) arrays -> {(length, code): payload}; verifies prefix-freeness."""
    m = {}
    for t1, (lens, codes) in enumerate(zip(len_tab, code_tab)):
        for tc, (ln, code) in enumerate(zip(lens, codes)):
            if ln == 0:
                continue  # invalid (TrailingOnes > TotalCoeff) combination
            key = (ln, code)
            assert key not in m, f"duplicate code {key}"
            m[key] = payload_fn(tc, t1)
    # prefix-freeness: no code may be a prefix of another
    keys = sorted(m.keys())
    for ln, code in keys:
        for ln2, code2 in keys:
            if ln2 > ln and (code2 >> (ln2 - ln)) == code:
                raise AssertionError(
                    f"code ({ln},{code:b}) is prefix of ({ln2},{code2:b})")
    return m


COEFF_TOKEN_MAPS = tuple(
    _build_prefix_map(_CT_LEN[c], _CT_CODE[c], lambda tc, t1: (tc, t1))
    for c in range(3))
COEFF_TOKEN_CDC_MAP = _build_prefix_map(
    _CT_CDC_LEN, _CT_CDC_CODE, lambda tc, t1: (tc, t1))

# ----------------------------------------------------------------------------
# Table 9-7 / 9-8: total_zeros for 4x4 blocks, indexed [TotalCoeff-1][tz].
_TZ_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9),
    (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6),
    (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5),
    (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6),
    (6, 5, 3, 3, 3, 2, 3, 4, 3, 6),
    (6, 4, 5, 3, 2, 2, 3, 3, 6),
    (6, 6, 4, 2, 2, 3, 2, 5),
    (5, 5, 3, 2, 2, 2, 4),
    (4, 4, 3, 3, 1, 3),
    (4, 4, 2, 1, 3),
    (3, 3, 1, 2),
    (2, 2, 1),
    (1, 1),
)
_TZ_CODE = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1),
    (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0),
    (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 5, 4, 3, 3, 2, 1, 1, 0),
    (1, 1, 1, 3, 3, 2, 2, 1, 0),
    (1, 0, 1, 3, 2, 1, 1, 1),
    (1, 0, 1, 3, 2, 1, 1),
    (0, 1, 1, 2, 1, 3),
    (0, 1, 1, 1, 1),
    (0, 1, 1, 1),
    (0, 1, 1),
    (0, 1),
)

# Table 9-9(a): total_zeros for chroma DC (4:2:0), indexed [TotalCoeff-1][tz].
_TZ_CDC_LEN = ((1, 2, 3, 3), (1, 2, 2), (1, 1))
_TZ_CDC_CODE = ((1, 1, 1, 0), (1, 1, 0), (1, 0))

# Table 9-10: run_before, indexed [min(zerosLeft,7)-1][run].
_RB_LEN = (
    (1, 1),
    (1, 2, 2),
    (2, 2, 2, 2),
    (2, 2, 2, 3, 3),
    (2, 2, 3, 3, 3, 3),
    (2, 3, 3, 3, 3, 3, 3),
    (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11),
)
_RB_CODE = (
    (1, 0),
    (1, 1, 0),
    (3, 2, 1, 0),
    (3, 2, 1, 1, 0),
    (3, 2, 3, 2, 1, 0),
    (3, 0, 1, 3, 2, 5, 4),
    (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1),
)


def _build_value_map(lens, codes):
    m = {}
    for value, (ln, code) in enumerate(zip(lens, codes)):
        key = (ln, code)
        assert key not in m
        m[key] = value
    return m


TOTAL_ZEROS_MAPS = tuple(_build_value_map(l, c)
                         for l, c in zip(_TZ_LEN, _TZ_CODE))
TOTAL_ZEROS_CDC_MAPS = tuple(_build_value_map(l, c)
                             for l, c in zip(_TZ_CDC_LEN, _TZ_CDC_CODE))
RUN_BEFORE_MAPS = tuple(_build_value_map(l, c)
                        for l, c in zip(_RB_LEN, _RB_CODE))


def _read_vlc(r: BitReader, prefix_map: dict, max_len: int = 16):
    code = 0
    for ln in range(1, max_len + 1):
        code = (code << 1) | r.read_bit()
        hit = prefix_map.get((ln, code))
        if hit is not None:
            return hit
    raise BitstreamError("invalid VLC code")


def read_coeff_token(r: BitReader, nC: int):
    """Parse coeff_token (spec 9.2.1) -> (TotalCoeff, TrailingOnes).

    Reference: read_ce_coefftoken (h264_cavlc.c:368-...).
    """
    if nC >= 8:
        v = r.read_bits(6)
        if v == 3:
            return 0, 0
        return (v >> 2) + 1, v & 3
    if nC < 0:
        return _read_vlc(r, COEFF_TOKEN_CDC_MAP, 8)
    cls = 0 if nC < 2 else (1 if nC < 4 else 2)
    return _read_vlc(r, COEFF_TOKEN_MAPS[cls], 16)


def residual_block_cavlc(r: BitReader, nC: int, start_idx: int, end_idx: int,
                         max_num_coeff: int):
    """Decode one CAVLC residual block (spec 7.3.5.3.2 / 9.2).

    Returns (coeff_levels list of length max_num_coeff in scan order,
    TotalCoeff).  Reference: residual_block_cavlc (h264_cavlc.c:79-365).
    """
    coeff = [0] * max_num_coeff
    total_coeff, trailing_ones = read_coeff_token(r, nC)
    if total_coeff == 0:
        return coeff, 0
    if total_coeff > end_idx - start_idx + 1:
        raise BitstreamError("TotalCoeff exceeds block size")

    # 9.2.2 level decoding
    levels = [0] * total_coeff
    suffix_length = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(total_coeff):
        if i < trailing_ones:
            levels[i] = 1 - 2 * r.read_bit()
            continue
        # level_prefix (spec 9.2.2.1)
        level_prefix = 0
        while r.read_bit() == 0:
            level_prefix += 1
            if level_prefix > 32:
                raise BitstreamError("level_prefix overflow")
        level_suffix_size = suffix_length
        if level_prefix == 14 and suffix_length == 0:
            level_suffix_size = 4
        elif level_prefix >= 15:
            level_suffix_size = level_prefix - 3
        level_suffix = (r.read_bits(level_suffix_size)
                        if level_suffix_size > 0 else 0)
        level_code = (min(15, level_prefix) << suffix_length) + level_suffix
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            levels[i] = (level_code + 2) >> 1
        else:
            levels[i] = -((level_code + 1) >> 1)
        if suffix_length == 0:
            suffix_length = 1
        if abs(levels[i]) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # 9.2.3 total_zeros
    if total_coeff < end_idx - start_idx + 1:
        if max_num_coeff == 4:  # chroma DC 4:2:0
            tz_map = TOTAL_ZEROS_CDC_MAPS[total_coeff - 1]
        else:
            tz_map = TOTAL_ZEROS_MAPS[total_coeff - 1]
        total_zeros = _read_vlc(r, tz_map, 9)
        # spec 9.2.3: total_zeros <= maxNumCoeff - TotalCoeff; the
        # 15-coefficient AC blocks share the 16-coefficient tables, so
        # a corrupt stream can code one zero too many and the placement
        # below would index past the block
        if total_zeros > end_idx - start_idx + 1 - total_coeff:
            raise BitstreamError("total_zeros exceeds block capacity")
    else:
        total_zeros = 0

    # 9.2.3 run_before
    runs = [0] * total_coeff
    zeros_left = total_zeros
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            runs[i] = _read_vlc(r, RUN_BEFORE_MAPS[min(zeros_left, 7) - 1], 11)
            zeros_left -= runs[i]
            if zeros_left < 0:
                raise BitstreamError("run_before exceeds zerosLeft")
        else:
            runs[i] = 0
    runs[total_coeff - 1] = zeros_left

    # 9.2.4 placement: levels[0] is the highest-frequency coefficient
    coeff_num = -1
    for i in range(total_coeff - 1, -1, -1):
        coeff_num += runs[i] + 1
        coeff[start_idx + coeff_num] = levels[i]
    return coeff, total_coeff

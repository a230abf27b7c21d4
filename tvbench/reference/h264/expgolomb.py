"""Exp-Golomb entropy readers (ITU-T H.264 clause 9.1).

Reference: minivideo/src/decoder/h264/h264_expgolomb.c (read_ue :92,
read_se :107, read_me :130, read_te :156).
"""

from __future__ import annotations

from .bitio import BitReader, BitstreamError

# Mapped exp-golomb: codeNum -> coded_block_pattern (ITU-T H.264 Table 9-4),
# as (intra_cbp, inter_cbp) pairs indexed by codeNum.
# ME_CBP_CHROMA_12: ChromaArrayType in {1,2} (48 entries).
# ME_CBP_CHROMA_03: ChromaArrayType in {0,3} (16 entries).
ME_CBP_CHROMA_12 = (
    (47, 0), (31, 16), (15, 1), (0, 2), (23, 4), (27, 8), (29, 32), (30, 3),
    (7, 5), (11, 10), (13, 12), (14, 15), (39, 47), (43, 7), (45, 11),
    (46, 13), (16, 14), (3, 6), (5, 9), (10, 31), (12, 35), (19, 37),
    (21, 42), (26, 44), (28, 33), (35, 34), (37, 36), (42, 40), (44, 39),
    (1, 43), (2, 45), (4, 46), (8, 17), (17, 18), (18, 20), (20, 24),
    (24, 19), (6, 21), (9, 26), (22, 28), (25, 23), (32, 27), (33, 29),
    (34, 30), (36, 22), (40, 25), (38, 38), (41, 41),
)

ME_CBP_CHROMA_03 = (
    (15, 0), (0, 1), (7, 2), (11, 4), (13, 8), (14, 3), (3, 5), (5, 10),
    (10, 12), (12, 15), (1, 7), (2, 11), (4, 13), (8, 14), (6, 6), (9, 9),
)


def read_ue(r: BitReader) -> int:
    """ue(v): unsigned exp-golomb (clause 9.1)."""
    zeros = 0
    while r.read_bit() == 0:
        zeros += 1
        if zeros > 32:
            raise BitstreamError("exp-golomb prefix too long")
    if zeros == 0:
        return 0
    return (1 << zeros) - 1 + r.read_bits(zeros)


def read_se(r: BitReader) -> int:
    """se(v): signed exp-golomb (clause 9.1.1)."""
    k = read_ue(r)
    # 0,1,2,3,4... -> 0,1,-1,2,-2...
    if k & 1:
        return (k + 1) >> 1
    return -(k >> 1)


def read_te(r: BitReader, value_range: int) -> int:
    """te(v): truncated exp-golomb (clause 9.1.1)."""
    if value_range == 1:
        return 1 - r.read_bit()
    return read_ue(r)


def read_me_cbp(r: BitReader, chroma_array_type: int, intra: bool) -> int:
    """me(v) for coded_block_pattern (clause 9.1.2, Table 9-4)."""
    code_num = read_ue(r)
    table = (ME_CBP_CHROMA_12 if chroma_array_type in (1, 2)
             else ME_CBP_CHROMA_03)
    if code_num >= len(table):
        raise BitstreamError(f"me(v) codeNum {code_num} out of range")
    return table[code_num][0 if intra else 1]

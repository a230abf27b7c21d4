"""Skewed-wavefront geometry (numpy).

Port of the geometry half of minivideo_tpu/ops/recon_wave.py: the
anti-diagonal schedule (wave w = 2*row + col, lane k at (r0-k, c0+2k))
and the per-mode selection matrices built from ops/predtables.py.  The
XLA wave loop of that module is not part of the port.
"""

from __future__ import annotations

import numpy as np

from ..models.h264.tables import BLK4x4_POS
from .predtables import PRED4, PRED8


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

_BLK_X = [int(BLK4x4_POS[b][0]) for b in range(16)]
_BLK_Y = [int(BLK4x4_POS[b][1]) for b in range(16)]

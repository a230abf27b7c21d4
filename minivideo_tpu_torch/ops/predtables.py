"""Static tap tables for directional intra prediction.

Every H.264 directional intra mode (spec 8.3.1.2 / 8.3.2.2) computes each
output pixel as (w1*s[i1] + w2*s[i2] + w3*s[i3] + rnd) >> shift over the
reference-sample vector
    s = [corner, top[0..2n-1], left[0..n-1]]      (len 1 + 2n + n)
so prediction becomes three gathers + a fused multiply-add — ideal for the
VPU.  The tables are built here once (host, numpy) per block size and
verified bit-exact against the sequential oracle in tests.

DC (mode 2) is availability-dependent and handled separately in recon.py.
"""

from __future__ import annotations

import numpy as np

N_MODES = 9


def _s_corner(n):
    return 0


def _s_top(n, x):
    assert -1 <= x < 2 * n
    return 0 if x == -1 else 1 + x        # p[-1,-1] aliases corner


def _s_left(n, y):
    assert -1 <= y < n
    return 0 if y == -1 else 1 + 2 * n + y


def build_pred_tables(n: int):
    """Returns (idx [9, n, n, 3] int32, w [9, n, n, 3] int32,
    rnd [9, n, n] int32, shift [9, n, n] int32).

    Mode 2 (DC) rows are zero (unused).
    """
    idx = np.zeros((N_MODES, n, n, 3), dtype=np.int32)
    w = np.zeros((N_MODES, n, n, 3), dtype=np.int32)
    rnd = np.zeros((N_MODES, n, n), dtype=np.int32)
    shift = np.zeros((N_MODES, n, n), dtype=np.int32)

    def put(m, y, x, taps, r, sh):
        for k, (i, wt) in enumerate(taps):
            idx[m, y, x, k] = i
            w[m, y, x, k] = wt
        rnd[m, y, x] = r
        shift[m, y, x] = sh

    T = lambda x: _s_top(n, x)
    L = lambda y: _s_left(n, y)
    C = _s_corner(n)

    for y in range(n):
        for x in range(n):
            # mode 0: Vertical
            put(0, y, x, [(T(x), 1)], 0, 0)
            # mode 1: Horizontal
            put(1, y, x, [(L(y), 1)], 0, 0)
            # mode 3: Diagonal down-left (spec 8.3.1.2.4)
            if x == n - 1 and y == n - 1:
                put(3, y, x, [(T(2 * n - 2), 1), (T(2 * n - 1), 3)], 2, 2)
            else:
                put(3, y, x, [(T(x + y), 1), (T(x + y + 1), 2),
                              (T(x + y + 2), 1)], 2, 2)
            # mode 4: Diagonal down-right (8.3.1.2.5)
            if x > y:
                d = x - y
                put(4, y, x, [(T(d - 2), 1), (T(d - 1), 2), (T(d), 1)], 2, 2)
            elif x < y:
                d = y - x
                put(4, y, x, [(L(d - 2), 1), (L(d - 1), 2), (L(d), 1)], 2, 2)
            else:
                put(4, y, x, [(T(0), 1), (C, 2), (L(0), 1)], 2, 2)
            # mode 5: Vertical-right (8.3.1.2.6)
            z = 2 * x - y
            if z >= 0 and z % 2 == 0:
                put(5, y, x, [(T(x - (y >> 1) - 1), 1),
                              (T(x - (y >> 1)), 1)], 1, 1)
            elif z >= 0:
                put(5, y, x, [(T(x - (y >> 1) - 2), 1),
                              (T(x - (y >> 1) - 1), 2),
                              (T(x - (y >> 1)), 1)], 2, 2)
            elif z == -1:
                put(5, y, x, [(L(0), 1), (C, 2), (T(0), 1)], 2, 2)
            else:
                d = y - 2 * x
                put(5, y, x, [(L(d - 1), 1), (L(d - 2), 2),
                              (L(d - 3), 1)], 2, 2)
            # mode 6: Horizontal-down (8.3.1.2.7)
            z = 2 * y - x
            if z >= 0 and z % 2 == 0:
                put(6, y, x, [(L(y - (x >> 1) - 1), 1),
                              (L(y - (x >> 1)), 1)], 1, 1)
            elif z >= 0:
                put(6, y, x, [(L(y - (x >> 1) - 2), 1),
                              (L(y - (x >> 1) - 1), 2),
                              (L(y - (x >> 1)), 1)], 2, 2)
            elif z == -1:
                put(6, y, x, [(L(0), 1), (C, 2), (T(0), 1)], 2, 2)
            else:
                d = x - 2 * y
                put(6, y, x, [(T(d - 1), 1), (T(d - 2), 2),
                              (T(d - 3), 1)], 2, 2)
            # mode 7: Vertical-left (8.3.1.2.8)
            if y % 2 == 0:
                put(7, y, x, [(T(x + (y >> 1)), 1),
                              (T(x + (y >> 1) + 1), 1)], 1, 1)
            else:
                put(7, y, x, [(T(x + (y >> 1)), 1),
                              (T(x + (y >> 1) + 1), 2),
                              (T(x + (y >> 1) + 2), 1)], 2, 2)
            # mode 8: Horizontal-up (8.3.1.2.9)
            z = x + 2 * y
            if z % 2 == 0 and z < 2 * (n - 1):
                put(8, y, x, [(L(y + (x >> 1)), 1),
                              (L(y + (x >> 1) + 1), 1)], 1, 1)
            elif z % 2 == 1 and z < 2 * (n - 1) - 1:
                put(8, y, x, [(L(y + (x >> 1)), 1),
                              (L(y + (x >> 1) + 1), 2),
                              (L(y + (x >> 1) + 2), 1)], 2, 2)
            elif z == 2 * (n - 1) - 1:
                put(8, y, x, [(L(n - 2), 1), (L(n - 1), 3)], 2, 2)
            else:
                put(8, y, x, [(L(n - 1), 1)], 0, 0)

    return idx, w, rnd, shift


PRED4 = build_pred_tables(4)
PRED8 = build_pred_tables(8)

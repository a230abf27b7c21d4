"""Host color conversion (the part of minivideo_tpu/export/image.py the
decoder needs): the numpy converter that DecodedPicture.cropped_rgb uses
where the decode produced no RGB on the card.  The picture writers come
with the rest of the export layer.

Reference: export_utils.c mb_to_rgb (:209-326), integer BT.601 studio
swing, coefficients 298/409/100/208/516 >> 8.
"""

from __future__ import annotations

import numpy as np


def yuv420_to_rgb_py(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                     ) -> np.ndarray:
    """Planar YCbCr 4:2:0 -> interleaved RGB888, integer BT.601
    (bit-compatible with the reference's mb_to_rgb)."""
    h, w = y.shape
    cb_up = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
    cr_up = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
    c = y.astype(np.int32) - 16
    d = cb_up.astype(np.int32) - 128
    e = cr_up.astype(np.int32) - 128
    r = (298 * c + 409 * e + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    b = (298 * c + 516 * d + 128) >> 8
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)

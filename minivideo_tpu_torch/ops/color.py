"""Color conversion on the planes' device: planar YCbCr 4:2:0 ->
interleaved RGB888.

Port of minivideo_tpu/ops/color.py (an XLA-fused elementwise pass there)
as torch ops: the decoder converts the uncropped planes of a batch on
their device, before they are read back with them.  Integer BT.601
studio swing, coefficients 298/409/100/208/516 >> 8 (reference
mb_to_rgb, export_utils.c:209-326), bit-exact with the JAX function and
with export/image.yuv420_to_rgb_py.
"""

from __future__ import annotations

import torch


def yuv420_to_rgb_device(y: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor) -> torch.Tensor:
    """[B, H, W] u8 luma + [B, H/2, W/2] u8 chroma -> [B, H, W, 3] u8, on
    the planes' device."""
    # 2x2 nearest-neighbour chroma upsample, cropped to the luma plane
    h, w = y.shape[1], y.shape[2]
    cb_up = cb.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr_up = cr.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    # int32 before the offsets (u8 wraps); >> is arithmetic on signed
    # ints, as in jnp, where // would round the negative products down
    c = y.to(torch.int32) - 16
    d = cb_up[:, :h, :w].to(torch.int32) - 128
    e = cr_up[:, :h, :w].to(torch.int32) - 128
    luma = 298 * c + 128              # shared by the three channels
    r = (luma + 409 * e) >> 8
    g = (luma - 100 * d - 208 * e) >> 8
    b = (luma + 516 * d) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)

"""MB tiles to raster planes: port of tools/probe_interleave.py's kernel.

The probe's Pallas kernel `dma_kernel` turns MB tiles [B, hmb*wmb, 256]
u8 (each 16x16, row-major) into raster planes [B, 16*hmb, 16*wmb] u8 with
strided DMAs.  Two versions live here:

  * `tiles_to_raster_cuda`: the hand-written CUDA kernel
    (csrc/interleave_kernel.cu), one launch per batch.
  * `tiles_to_raster_plain`: the same function as a torch view, permute
    and reshape, on any device: the yardstick of the kernel, and what
    the CPU runs.
"""

from __future__ import annotations

import torch

from . import kernels


def _shape(tiles, wmb, hmb):
    B = tiles.shape[0]
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (hmb * wmb, 256):
        raise ValueError(f"tiles: expected shape ({B}, {hmb * wmb}, 256), "
                         f"got {tuple(tiles.shape)}")
    if tiles.dtype != torch.uint8:
        raise TypeError(f"tiles: expected torch.uint8, got {tiles.dtype}")
    return B


def tiles_to_raster_plain(tiles, wmb, hmb):
    """[B, hmb*wmb, 256] u8 tiles -> [B, 16*hmb, 16*wmb] u8 raster."""
    B = _shape(tiles, wmb, hmb)
    return tiles.reshape(B, hmb, wmb, 16, 16).permute(0, 1, 3, 2, 4).reshape(
        B, 16 * hmb, 16 * wmb)


def tiles_to_raster_cuda(tiles, wmb, hmb):
    """tiles_to_raster_plain with csrc/interleave_kernel.cu, one launch.
    `tiles_to_raster_cuda.launches` counts the kernel's launches."""
    B = _shape(tiles, wmb, hmb)
    if not tiles.is_cuda:
        raise ValueError(f"tiles: expected a CUDA tensor, got "
                         f"{tiles.device}")
    if not tiles.is_contiguous():
        raise ValueError("tiles: expected a contiguous tensor")
    lib = kernels.load()
    out = torch.empty((B, 16 * hmb, 16 * wmb), dtype=torch.uint8,
                      device=tiles.device)
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    with torch.cuda.device(tiles.device):
        err = lib.mvt_interleave_run(tiles.data_ptr(), out.data_ptr(), B,
                                     wmb, hmb, stream)
    if err != 0:
        raise RuntimeError(f"interleave_kernel launch failed: CUDA error "
                           f"{err}")
    tiles_to_raster_cuda.launches += 1
    return out


# plain integer count of csrc/interleave_kernel.cu launches: the wrapper
# adds one per launch it made, and nowhere else
tiles_to_raster_cuda.launches = 0


"""The device staging mode's MB-major records laid out into the wave
kernel's per-wave feeds.

The native parser writes one int16 record per macroblock in raster order
(native.REC_*: the luma, chroma and DC slabs of ops/slab.py, then meta
rows 0..33).  csrc/wave_kernel.cu reads the feeds [B, W, S, maxw] where
lane k of wave w holds MB skew_idx[w, k] (recon_wave.skew_tables) and the
padded lanes hold zeros:

    feed[b, w, s, k] = rec[b, skew_idx[w, k], s] if skew_valid[w, k] else 0

split into meta [B, W, META_ROWS, maxw] int32 (rows 34..39 zero) and the
luma / chroma / DC slabs [B, W, 256|128|32, maxw] int16, in the order of
recon_fused.DEVICE_STAGING.  Two versions live here:

  * `wave_layout_cuda`: the hand-written CUDA kernel
    (csrc/wave_layout_kernel.cu), one launch per batch on the current
    stream, writing every element of the feeds, padding included.
  * `wave_layout_plain`: the same as a torch index gather, on any device:
    what the CPU runs, and the yardstick of the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..native import REC_CHROMA, REC_DC, REC_LEN, REC_LUMA, REC_META, \
    REC_META_ROWS
from . import kernels
from .recon_wave import skew_tables
from .slab import DC_ROWS, META_ROWS


@functools.lru_cache(maxsize=None)
def _geometry(wmb, hmb):
    g = skew_tables(wmb, hmb)
    idx = np.where(g["skew_valid"], g["skew_idx"], -1).astype(np.int32)
    return g["n_waves"], g["maxw"], idx


def _check(records, wmb, hmb) -> int:
    n = wmb * hmb
    if records.dim() != 3 or tuple(records.shape[1:]) != (n, REC_LEN):
        raise ValueError(f"records: expected shape (B, {n}, {REC_LEN}), "
                         f"got {tuple(records.shape)}")
    if records.dtype != torch.int16:
        raise TypeError(f"records: expected torch.int16, got "
                        f"{records.dtype}")
    return records.shape[0]


def feed_shapes(wmb: int, hmb: int, batch: int):
    """[(shape, dtype)] of the four feeds, in DEVICE_STAGING order."""
    W, maxw, _ = _geometry(wmb, hmb)
    return [((batch, W, S, maxw), dt) for S, dt in (
        (META_ROWS, torch.int32), (256, torch.int16), (128, torch.int16),
        (DC_ROWS, torch.int16))]


def empty_feeds(wmb: int, hmb: int, batch: int, device):
    """The four feeds, uninitialised, on `device` (for `out=`)."""
    return tuple(torch.empty(s, dtype=dt, device=device)
                 for s, dt in feed_shapes(wmb, hmb, batch))


def wave_layout_plain(records, wmb: int, hmb: int):
    """[B, n, REC_LEN] int16 records -> the four feeds (meta, luma,
    chroma, dc) on the records' device, by an index gather."""
    B = _check(records, wmb, hmb)
    W, maxw, idx = _geometry(wmb, hmb)
    flat = torch.as_tensor(idx.reshape(-1), device=records.device).long()
    x = records[:, flat.clamp(min=0)]
    x = torch.where((flat >= 0)[None, :, None], x, x.new_zeros(()))
    x = x.reshape(B, W, maxw, REC_LEN).permute(0, 1, 3, 2)
    meta = torch.zeros((B, W, META_ROWS, maxw), dtype=torch.int32,
                       device=records.device)
    meta[:, :, :REC_META_ROWS] = x[:, :, REC_META:REC_META + REC_META_ROWS]
    return (meta, *(x[:, :, a:b].contiguous() for a, b in (
        (REC_LUMA, REC_CHROMA), (REC_CHROMA, REC_DC), (REC_DC, REC_META))))


@functools.lru_cache(maxsize=16)
def _device_index(wmb, hmb, device):
    return torch.as_tensor(_geometry(wmb, hmb)[2], device=device)


def wave_layout_cuda(records, wmb: int, hmb: int, out=None):
    """wave_layout_plain with csrc/wave_layout_kernel.cu, one launch on
    the records' device and its current stream; into `out` (four
    contiguous feeds there, as empty_feeds gives) where given.
    `wave_layout_cuda.launches_by_device` counts its launches per card
    index."""
    B = _check(records, wmb, hmb)
    if not records.is_cuda:
        raise ValueError(f"records: expected a CUDA tensor, got "
                         f"{records.device}")
    if not records.is_contiguous():
        raise ValueError("records: expected a contiguous tensor")
    dev = records.device
    W, maxw, _ = _geometry(wmb, hmb)
    if out is None:
        out = empty_feeds(wmb, hmb, B, dev)
    for t, (shape, dt) in zip(out, feed_shapes(wmb, hmb, B)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"out: expected contiguous {dt} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    lib = kernels.load()
    idx = _device_index(wmb, hmb, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mvt_layout_run(records.data_ptr(), idx.data_ptr(),
                                 *(t.data_ptr() for t in out), B,
                                 wmb * hmb, W, maxw, stream)
    if err != 0:
        raise RuntimeError(f"wave_layout_kernel launch failed: CUDA error "
                           f"{err}")
    by_card = wave_layout_cuda.launches_by_device
    by_card[dev.index] = by_card.get(dev.index, 0) + 1
    return tuple(out)


# the same count per card as recon_fused.wave_kernel_cuda's: a plain dict
# of device index to launches, which the wrapper adds one to per launch
# it made, and which callers reset to {}
wave_layout_cuda.launches_by_device = {}


def wave_layout(records, wmb: int, hmb: int, out=None):
    """The feeds of `records` on their device: the CUDA kernel for CUDA
    tensors, the plain gather for CPU tensors (copied into `out` where
    given)."""
    if records.is_cuda:
        return wave_layout_cuda(records, wmb, hmb, out)
    if records.device.type != "cpu":
        raise ValueError(f"no records layout for {records.device}")
    feeds = wave_layout_plain(records, wmb, hmb)
    if out is None:
        return feeds
    for o, f in zip(out, feeds):
        o.copy_(f)
    return tuple(out)

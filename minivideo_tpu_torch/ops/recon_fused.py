"""Batch-fused wavefront reconstruction: the fused engine of the port.

Port of minivideo_tpu/ops/recon_fused.py.  Two versions of the TPU
kernel `_wave_kernel` live here:

  * `wave_kernel_cuda`: the hand-written CUDA kernel
    (csrc/wave_kernel.cu), one persistent launch per batch with one block
    per (frame, MB row) and flags between rows, reading the native
    parser's device-layout staging [B, W, S, maxw] directly and writing
    raster Y/Cb/Cr planes.  It runs for tensors on a CUDA device.
  * `wave_loop_plain`: the TPU kernel's grid loop in plain PyTorch: the
    batch merged into the lane axis (L = B * maxw), one anti-diagonal
    wave at a time (wave w = 2*row + col), its state machine
    (segment-masked lane rolls, right column and corners, double-buffered
    bottom rows) over the per-wave feeds [W, S, L], followed by
    `unskew_fused`.  It runs for tensors on the CPU, and on the card only
    where a test or chip_smoke.py compares the kernel with it.

Both read the device-layout feeds [B, W, S, maxw].  The device mode's
MB-major records reach them through `device_feeds` (ops/wave_layout.py:
its CUDA kernel on a card, its plain gather on the CPU), the raster and
slot-record layouts through `raster_feeds` / `records_feeds` (ops/slab.py's
feeds, torch ops on the staging's device), so `reconstruct_frames_fused`
dispatches on `packed.slots` first and then on the device of the staging
tensors: a CUDA tensor launches the kernels or raises; there is no
fallback from one version to the other.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from . import kernels
from . import slab as sl
from .recon import PackedFrames
from .recon_lane import wave_compute_lane
from .recon_wave import TAP_ROWS4, TAP_ROWS8, skew_tables
from .wave_layout import wave_layout


def wave_schedule(g):
    """Per-wave lane-shift schedules (dr0, shtop) from the skew tables."""
    n_waves = g["n_waves"]
    r0 = g["r0"].astype(np.int64)
    dr0 = np.diff(r0, prepend=r0[0]).astype(np.int32)
    r0m2 = np.concatenate([r0[:1], r0[:1], r0[:-2]])
    shtop = np.where(np.arange(n_waves) >= 2, 1 - (r0 - r0m2), 0)
    shtop = shtop.astype(np.int32)
    assert set(np.unique(dr0)) <= {0, 1}
    assert set(np.unique(shtop)) <= {0, 1}
    return dr0, shtop


def _seg_masks(maxw, batch):
    """[1, B*maxw] int32 masks marking lanes whose roll source is inside
    the same frame segment (right: source lane-1, left: source lane+1)."""
    lane = np.arange(batch * maxw) % maxw
    right = (lane >= 1).astype(np.int32)[None]
    left = (lane <= maxw - 2).astype(np.int32)[None]
    return right, left


def _roll_right_seg(x, mask):
    """Lane k <- k-1 within each maxw-lane frame segment; lane 0 zero."""
    return torch.where(mask > 0, torch.roll(x, 1, 1), 0)


def _roll_left_seg(x, mask):
    """Lane k <- k+1 within each segment; last segment lane zero."""
    return torch.where(mask > 0, torch.roll(x, -1, 1), 0)


# ---------------------------------------------------------------------------
# plain version of the wave kernel


def wave_step(ry, rc, top_row, tr_row, top_c, meta, coefl, coefc, dcs,
              tables, has8x8=True, haspcm=True):
    """One wave of the TPU kernel's state machine on one lane strip.

    ry / rc [24, l] are the row states (left column, corners) after the
    wave's right roll; top_row / tr_row / top_c [16, l] the bottom rows
    above and above-right after its left rolls; meta [META_ROWS, l]
    int32 and coefl [256, l] / coefc [128, l] / dcs [DC_ROWS, l] the
    strip's slice of the wave's feeds; tables the int32 scale tables
    (t4, t8, tcb, tcr) on the strip's device.  Returns (tile [256, l],
    ctile [128, l], row_y, row_c, bot_y, bot_c): the wave's int32 tiles,
    the new row states, and the luma / chroma bottom rows that become
    the next wave's botA (its botB is this wave's botA)."""
    l = ry.shape[-1]
    meta = meta.to(torch.int32)
    parsed = meta[sl.R_PARSED:sl.R_PARSED + 1]
    res_luma, res_chroma = sl.residual_from_slabs(
        coefl.to(torch.int32), coefc.to(torch.int32), dcs.to(torch.int32),
        meta, *tables, has8x8=has8x8, haspcm=haspcm)
    tile, ctile = wave_compute_lane(
        ry[:16], ry[16:17], top_row, tr_row, rc[:16], rc[16:17],
        rc[17:18], top_c, meta[sl.R_KIND:sl.R_KIND + 1],
        meta[sl.R_AL:sl.R_AL + 1] > 0, meta[sl.R_AT:sl.R_AT + 1] > 0,
        meta[sl.R_ATL:sl.R_ATL + 1] > 0, meta[sl.R_ATR:sl.R_ATR + 1] > 0,
        parsed, meta[sl.R_MODES4:sl.R_MODES4 + 16],
        meta[sl.R_MODES8:sl.R_MODES8 + 4],
        meta[sl.R_I16M:sl.R_I16M + 1], meta[sl.R_CMODE:sl.R_CMODE + 1],
        res_luma, res_chroma, has8x8=has8x8, haspcm=haspcm)

    # state updates: right column + corner, the new bottom rows
    def zeros(n):
        return torch.zeros((n, l), dtype=torch.int32, device=ry.device)

    upd = parsed > 0
    new_row = torch.cat([tile[15::16], top_row[15:16], zeros(7)])
    new_rowc = torch.cat([ctile[7::8], top_c[7:8], top_c[15:16], zeros(6)])
    return (tile, ctile, torch.where(upd, new_row, ry),
            torch.where(upd, new_rowc, rc), tile[240:256],
            torch.cat([ctile[56:64], ctile[120:128]]))


def wave_loop_plain(meta_s, coefl_s, coefc_s, dcs_s, ls4, ls8, g, batch,
                    has8x8=True, haspcm=True):
    """The TPU kernel's grid loop in plain PyTorch.

    Feeds: meta_s [W, META_ROWS, L] int32, coefl_s [W, 256, L],
    coefc_s [W, 128, L], dcs_s [W, DC_ROWS, L] int16, L = batch * maxw.
    Returns (out_y [W, 256, L], out_c [W, 128, L]) uint8 tiles."""
    W, maxw = g["n_waves"], g["maxw"]
    L = batch * maxw
    dev = meta_s.device
    dr0s, shtops = wave_schedule(g)
    mr, ml = (torch.as_tensor(m, device=dev)
              for m in _seg_masks(maxw, batch))
    tables = tuple(torch.as_tensor(t, device=dev)
                   for t in sl.scale_tables(ls4, ls8))

    def zeros(n):
        return torch.zeros((n, L), dtype=torch.int32, device=dev)

    row_y, row_c = zeros(24), zeros(24)
    botA_y, botB_y, botA_c, botB_c = (zeros(16) for _ in range(4))
    out_y = torch.empty((W, 256, L), dtype=torch.uint8, device=dev)
    out_c = torch.empty((W, 128, L), dtype=torch.uint8, device=dev)
    for w in range(W):
        dr0, shtop = int(dr0s[w]), int(shtops[w])
        ry = _roll_right_seg(row_y, mr) if dr0 == 1 else row_y
        rc = _roll_right_seg(row_c, mr) if dr0 == 1 else row_c
        top_row = _roll_left_seg(botB_y, ml) if shtop == 1 else botB_y
        tr_row = _roll_left_seg(botA_y, ml) if dr0 == 0 else botA_y
        top_c = _roll_left_seg(botB_c, ml) if shtop == 1 else botB_c
        tile, ctile, row_y, row_c, bot_y, bot_c = wave_step(
            ry, rc, top_row, tr_row, top_c, meta_s[w], coefl_s[w],
            coefc_s[w], dcs_s[w], tables, has8x8=has8x8, haspcm=haspcm)
        out_y[w] = tile.to(torch.uint8)
        out_c[w] = ctile.to(torch.uint8)
        botB_y, botA_y = botA_y, bot_y
        botB_c, botA_c = botA_c, bot_c
    return out_y, out_c


def unskew_fused(out_y, out_c, g, batch):
    """[W, 256|128, B*maxw] -> (Y, Cb, Cr) raster planes [B, H, W]."""
    wmb, hmb = g["wmb"], g["hmb"]
    n_waves, maxw = g["skew_idx"].shape
    B = batch
    unskew = torch.as_tensor(
        g["w_of"].astype(np.int64) * maxw + g["k_of"], device=out_y.device)

    ty = out_y.reshape(n_waves, 256, B, maxw).permute(2, 0, 3, 1)
    ty = ty.reshape(B, n_waves * maxw, 256)[:, unskew]
    Y = ty.reshape(B, hmb, wmb, 16, 16).permute(0, 1, 3, 2, 4).reshape(
        B, hmb * 16, wmb * 16)

    tc = out_c.reshape(n_waves, 128, B, maxw).permute(2, 0, 3, 1)
    tc = tc.reshape(B, n_waves * maxw, 128)[:, unskew]
    tc = tc.reshape(B, hmb, wmb, 2, 8, 8)
    Cb, Cr = (tc[:, :, :, ic].permute(0, 1, 3, 2, 4).reshape(
        B, hmb * 8, wmb * 8) for ic in range(2))
    return Y, Cb, Cr


# ---------------------------------------------------------------------------
# the CUDA kernel


@functools.lru_cache(maxsize=None)
def _geometry(wmb, hmb):
    """(n_waves, maxw) of a wmb x hmb picture."""
    g = skew_tables(wmb, hmb)
    return g["n_waves"], g["maxw"]


# the tap tables as the kernel reads them: one byte per entry (indices
# below 25, weights, rounding and shift below 4)
_TAPS4_U8, _TAPS8_U8 = (np.ascontiguousarray(t, np.uint8)
                        for t in (TAP_ROWS4, TAP_ROWS8))
assert all((t8 == t).all() for t8, t in ((_TAPS4_U8, TAP_ROWS4),
                                         (_TAPS8_U8, TAP_ROWS8)))


@functools.lru_cache(maxsize=16)
def _cached_tables(ls4_bytes, ls8_bytes, device):
    ls4 = np.frombuffer(ls4_bytes, np.int32).reshape(3, 6, 4, 4)
    ls8 = np.frombuffer(ls8_bytes, np.int32).reshape(6, 8, 8)
    return tuple(torch.as_tensor(np.array(a), device=device)
                 for a in (ls4, ls8, _TAPS4_U8, _TAPS8_U8))


def _device_tables(ls4, ls8, device):
    """int32 LevelScale [3, 6, 4, 4] / [6, 8, 8] and uint8 prediction tap
    tables on `device`, in the layouts the kernel indexes; copied once
    per (scaling lists, device)."""
    ls4 = np.ascontiguousarray(ls4, np.int32)
    ls8 = np.ascontiguousarray(ls8, np.int32)
    if ls4.shape != (3, 6, 4, 4) or ls8.shape != (6, 8, 8):
        raise ValueError(f"LevelScale shapes {ls4.shape}, {ls8.shape}: "
                         f"expected (3, 6, 4, 4) and (6, 8, 8)")
    return _cached_tables(ls4.tobytes(), ls8.tobytes(), device)


def _check(x, name, dtype, shape):
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _wave_launch(load, meta_slab, luma_slab, chroma_slab, dc_slab, ls4,
                 ls8, wmb, hmb, has8x8, haspcm):
    """Check the staging, allocate the planes and the counters, and make
    one launch of the library that load() returns (kernels.load or a
    build of it with defines).  Returns the planes and the error word,
    which the launch may still be writing."""
    W, maxw = _geometry(wmb, hmb)
    B = meta_slab.shape[0]
    _check(meta_slab, "meta_slab", torch.int32, (B, W, sl.META_ROWS, maxw))
    _check(luma_slab, "luma_slab", torch.int16, (B, W, 256, maxw))
    _check(chroma_slab, "chroma_slab", torch.int16, (B, W, 128, maxw))
    _check(dc_slab, "dc_slab", torch.int16, (B, W, sl.DC_ROWS, maxw))
    dev = meta_slab.device
    for x in (luma_slab, chroma_slab, dc_slab):
        if x.device != dev:
            raise ValueError("staging tensors lie on different devices")
    lib = load()
    tabs = _device_tables(ls4, ls8, dev)
    Y = torch.empty((B, 16 * hmb, 16 * wmb), dtype=torch.uint8, device=dev)
    Cb = torch.empty((B, 8 * hmb, 8 * wmb), dtype=torch.uint8, device=dev)
    Cr = torch.empty_like(Cb)
    # row progress [B, hmb], then the row ticket, then the error word
    ctr = torch.zeros(B * hmb + 2, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (meta_slab, luma_slab, chroma_slab,
                                   dc_slab, *tabs, Y, Cb, Cr, ctr)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the annotation marks the launch in a profiler trace on the host side
    # (bench.read_trace), where no record of it is dropped
    with torch.cuda.device(dev), torch.profiler.record_function(
            "wave_kernel_cuda"):
        err = lib.mvt_wave_run(*ptrs, B, W, maxw, wmb, hmb, int(has8x8),
                               int(haspcm), stream)
    if err != 0:
        raise RuntimeError(f"wave_kernel launch failed: CUDA error {err}")
    return Y, Cb, Cr, ctr[-1:]


# error words of launches made with check=False, until check_waits()
_unchecked: list = []


def check_waits(*words):
    """Wait for the launches whose error words are `words`, and for every
    launch made with check=False since the last call, and raise if a wait
    for the row above timed out in any of them."""
    words = [*_unchecked, *words]
    _unchecked.clear()
    if any(int(w) != 0 for w in words):
        raise RuntimeError("wave_kernel: a wait for the row above timed "
                           "out; the planes are not valid")


def wave_kernel_cuda(meta_slab, luma_slab, chroma_slab, dc_slab, ls4, ls8,
                     wmb, hmb, has8x8=True, haspcm=True, check=True):
    """Reconstruct a batch with csrc/wave_kernel.cu in one launch.

    Staging tensors on one CUDA device, device layout [B, W, S, maxw]:
    meta int32 (S = 40), luma/chroma/dc int16 (S = 256/128/32).  Returns
    raster (Y [B, 16*hmb, 16*wmb], Cb, Cr [B, 8*hmb, 8*wmb]) uint8.
    With `check` (the default) it waits for the kernel and raises if a
    wait between rows timed out (see check_waits); check=False leaves the
    launch in flight, for timing or for other cards' launches to follow,
    and the next check_waits() checks it.  `wave_kernel_cuda.launches`
    counts the kernel's launches, `wave_kernel_cuda.launches_by_device`
    them per card index."""
    Y, Cb, Cr, word = _wave_launch(
        kernels.load, meta_slab, luma_slab, chroma_slab, dc_slab, ls4,
        ls8, wmb, hmb, has8x8, haspcm)
    wave_kernel_cuda.launches += 1
    by_card, card = wave_kernel_cuda.launches_by_device, meta_slab.device.index
    by_card[card] = by_card.get(card, 0) + 1
    if check:
        check_waits(word)
    else:
        _unchecked.append(word)
    return Y, Cb, Cr


# plain integer count of csrc/wave_kernel.cu launches: the wrapper adds
# one per batch once mvt_wave_run has launched, and nowhere else; callers
# reset it to 0 to count a run.  Beside it the same count per card, a
# plain dict of device index to launches, which callers reset to {}.
wave_kernel_cuda.launches = 0
wave_kernel_cuda.launches_by_device = {}


# ---------------------------------------------------------------------------
# entry points


def reconstruct_plain(meta_slab, luma_slab, chroma_slab, dc_slab, ls4, ls8,
                      wmb, hmb, has8x8=True, haspcm=True):
    """Plain version of wave_kernel_cuda on any device: the feeds'
    transpose, the plain wave loop and the unskew."""
    g = skew_tables(wmb, hmb)
    g["wmb"], g["hmb"] = wmb, hmb
    W, maxw = g["n_waves"], g["maxw"]
    B = meta_slab.shape[0]
    L = B * maxw

    def feed(x, S):
        return x.permute(1, 2, 0, 3).reshape(W, S, L)

    out_y, out_c = wave_loop_plain(
        feed(meta_slab, sl.META_ROWS), feed(luma_slab, 256),
        feed(chroma_slab, 128), feed(dc_slab, sl.DC_ROWS), ls4, ls8, g, B,
        has8x8=has8x8, haspcm=haspcm)
    return unskew_fused(out_y, out_c, g, B)


def make_reconstruct_fused_slots2(wmb: int, hmb: int, batch: int,
                                  has8x8: bool = True, haspcm: bool = True,
                                  check: bool = True):
    """Reconstructor over the device layout's four feeds (device_feeds):
    the CUDA kernel for CUDA tensors, the plain loop for CPU tensors.  `check`
    goes to wave_kernel_cuda: False leaves each launch in flight, its
    waits checked by the next check_waits()."""

    def recon(meta_slab, luma_slab, chroma_slab, dc_slab, ls4, ls8):
        if meta_slab.shape[0] != batch:
            raise ValueError(f"expected batch {batch}, "
                             f"got {meta_slab.shape[0]}")
        args = (meta_slab, luma_slab, chroma_slab, dc_slab, ls4, ls8,
                wmb, hmb)
        if meta_slab.is_cuda:
            return wave_kernel_cuda(*args, has8x8=has8x8, haspcm=haspcm,
                                    check=check)
        if meta_slab.device.type != "cpu":
            raise ValueError(f"no fused engine for {meta_slab.device}")
        return reconstruct_plain(*args, has8x8=has8x8, haspcm=haspcm)

    return recon


# the device layout's feeds, in the order the reconstructors take
DEVICE_STAGING = ("meta_slab", "luma_slab", "chroma_slab", "dc_slab")


def device_feeds(arrays, wmb, hmb):
    """The four feeds (DEVICE_STAGING order) of device-mode staging
    tensors `arrays`: the feeds themselves where `arrays` holds them
    (laid out already, or the JAX package's device layout carried across
    by convert.packed_from_numpy), else `arrays["records"]` laid out on
    their device by ops/wave_layout.py."""
    if all(k in arrays for k in DEVICE_STAGING):
        return [arrays[k] for k in DEVICE_STAGING]
    return list(wave_layout(arrays["records"], wmb, hmb))


def raster_feeds(arrays, cb_off, cr_off, wmb, hmb, batch):
    """Raster PackedFrames arrays (tensors) -> the device-layout staging
    (meta_slab, luma_slab, chroma_slab, dc_slab) [B, W, S, maxw] that
    the kernel reads: slab records assembled and skewed on the arrays'
    device."""
    g = skew_tables(wmb, hmb)
    luma, chroma, dcs = sl.slabs_from_raster(arrays)
    meta = sl.meta_raster(arrays, cb_off, cr_off, wmb, hmb)
    return (sl.vmask_feed(sl.skew_feed(meta, g, batch), g, batch),
            sl.skew_feed_slab(luma, g, batch).to(torch.int16),
            sl.skew_feed_slab(chroma, g, batch).to(torch.int16),
            sl.skew_feed_slab(dcs, g, batch).to(torch.int16))


def records_feeds(arrays, cb_off, cr_off, wmb, hmb, batch):
    """Slot-record PackedFrames arrays (tensors) -> the device-layout
    staging: meta from the raster per-MB arrays by the skew gather, the
    slabs by one transpose each."""
    g = skew_tables(wmb, hmb)
    meta = sl.meta_raster(arrays, cb_off, cr_off, wmb, hmb)
    return (sl.vmask_feed(sl.skew_feed(meta, g, batch), g, batch),
            *(sl.slot_feed(arrays[k], g, batch, torch.int16)
              for k in ("luma_slab", "chroma_slab", "dc_slab")))


def make_reconstruct_fused(wmb: int, hmb: int, batch: int,
                           has8x8: bool = True, haspcm: bool = True,
                           check: bool = True):
    """Reconstructor over RASTER-order PackedFrames tensors (the Python
    parsers' and the native raster parse's layout): raster_feeds, then
    the device-layout reconstructor (`check` as there)."""
    recon2 = make_reconstruct_fused_slots2(wmb, hmb, batch, has8x8, haspcm,
                                           check)

    def recon(arrays, ls4, ls8, cb_off, cr_off):
        return recon2(*raster_feeds(arrays, cb_off, cr_off, wmb, hmb,
                                    batch), ls4, ls8)

    return recon


def make_reconstruct_fused_slots(wmb: int, hmb: int, batch: int,
                                 has8x8: bool = True, haspcm: bool = True,
                                 check: bool = True):
    """Reconstructor over slot-record PackedFrames tensors: records_feeds,
    then the device-layout reconstructor (`check` as there)."""
    recon2 = make_reconstruct_fused_slots2(wmb, hmb, batch, has8x8, haspcm,
                                           check)

    def recon(arrays, ls4, ls8, cb_off, cr_off):
        return recon2(*records_feeds(arrays, cb_off, cr_off, wmb, hmb,
                                     batch), ls4, ls8)

    return recon


def to_device(packed: PackedFrames, device=None) -> PackedFrames:
    """`packed` with its staging arrays as tensors on `device` (the
    staging copy).  device=None leaves tensors where they lie and puts
    numpy staging on the GPU (raising where there is none)."""
    arrs = packed.arrays
    if device is None and all(isinstance(a, torch.Tensor)
                              for a in arrs.values()):
        return packed
    device = resolve_device(device)
    out = dataclasses.replace(packed, arrays={
        k: torch.as_tensor(a, device=device) for k, a in arrs.items()})
    out.__dict__["haspcm"] = packed.haspcm     # scanned on the host
    return out


def reconstruct_frames_fused(packed: PackedFrames, device=None,
                             check: bool = True):
    """Decode a PackedFrames batch of any staging layout with the fused
    engine on `device` (default: where its staging tensors lie, or the
    GPU for numpy staging).  Dispatches on packed.slots; every layout
    reaches the same kernel (CUDA tensors) or plain loop (CPU tensors).
    `check` goes to wave_kernel_cuda.  Returns (Y, Cb, Cr) uint8 tensors
    [B, H, W] on that device."""
    packed = to_device(packed, device)
    args = (packed.wmb, packed.hmb, packed.batch, packed.has8x8,
            packed.haspcm, check)
    if packed.slots == 2:
        return make_reconstruct_fused_slots2(*args)(
            *device_feeds(packed.arrays, packed.wmb, packed.hmb), packed.ls4,
            packed.ls8)
    make = (make_reconstruct_fused_slots if packed.slots == 1
            else make_reconstruct_fused)
    return make(*args)(packed.arrays, packed.ls4, packed.ls8,
                       *packed.chroma_qp_off)

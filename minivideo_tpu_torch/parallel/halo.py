"""Intra-frame parallelism: one frame's wavefront split across mesh
entries, with one edge lane of boundary state exchanged per wave.

Port of minivideo_tpu/parallel/halo.py.  The fused engine's lane axis
(L = batch * maxw, each lane one macroblock of the current
anti-diagonal) is split into contiguous strips, one per entry of a mesh
axis.  The per-wave lane rolls of the boundary-state buffers are the
only cross-lane dataflow of the reconstruction, so each strip needs one
lane from each neighbour per wave: the last lane of its left
neighbour's row states (the right rolls) and the first lane of its right
neighbour's bottom rows (the left rolls).  Everything else is lane-local
and runs unchanged per strip: the strips step through
ops/recon_fused.wave_step, the state machine of the plain wave loop.

The JAX module shards the loop with shard_map and exchanges the edges
with two lax.ppermute per buffer and wave.  Here the strips run in
lockstep from one process, one wave at a time, and each wave starts with
ONE exchange of the previous wave's edges: every strip packs its
EDGE_LANES int32 into its row of a zeroed [strips + 2, EDGE_LANES]
buffer (rows 0 and strips + 1 stay zero, the global edges, as ppermute
leaves an unsourced destination zero), and reads its neighbours' rows.
Across processes (multihost.py) the same buffer goes through one
all_reduce(SUM) per wave, each process filling its own strips' rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.recon import PackedFrames
from ..ops.recon_fused import (_seg_masks, device_feeds, raster_feeds,
                               records_feeds, to_device, unskew_fused,
                               wave_schedule, wave_step)
from ..ops.recon_wave import skew_tables
from ..ops import slab as sl

# one strip's edges per wave: the last lane of row_y and row_c (24 rows
# each), the first lane of botB_y, botA_y and botB_c (16 rows each)
_ROW_Y, _ROW_C = slice(0, 24), slice(24, 48)
_BOTB_Y, _BOTA_Y, _BOTB_C = slice(48, 64), slice(64, 80), slice(80, 96)
EDGE_LANES = 96


def _strip_devices(mesh, axis: str):
    """The device of each strip: entry i along `axis` of `mesh` (the
    first entry of any other axis, over which the loop is replicated)."""
    ax = mesh.axis_names.index(axis)
    along = np.moveaxis(mesh.devices, ax, 0)
    return [resolve_device(d) for d in along.reshape(len(along), -1)[:, 0]]


def lane_feeds(staging):
    """Device-layout staging [B, W, S, maxw] -> the loop's feeds
    [W, S, B * maxw], the batch fused into the lane axis."""
    return [x.permute(1, 2, 0, 3).reshape(x.shape[1], x.shape[2], -1)
            for x in staging]


def _roll_right(x, edge, mask):
    """Lane k <- k-1 across the strips: the left neighbour's last lane
    enters at lane 0; zero where the source lies in another frame."""
    return torch.where(mask > 0, torch.cat([edge[:, None], x[:, :-1]], 1), 0)


def _roll_left(x, edge, mask):
    """Lane k <- k+1 across the strips: the right neighbour's first lane
    enters at the last lane."""
    return torch.where(mask > 0, torch.cat([x[:, 1:], edge[:, None]], 1), 0)


class _Strip:
    """One strip's feeds, masks, tables, state and output tiles."""

    def __init__(self, feeds, lanes, mr, ml, ls4, ls8, n_waves, dev):
        self.dev = dev
        self.feeds = [f[..., lanes].to(dev).contiguous() for f in feeds]
        self.mr = torch.as_tensor(mr[:, lanes], device=dev)
        self.ml = torch.as_tensor(ml[:, lanes], device=dev)
        self.tables = tuple(torch.as_tensor(t, device=dev)
                            for t in sl.scale_tables(ls4, ls8))
        l = lanes.stop - lanes.start

        def zeros(n):
            return torch.zeros((n, l), dtype=torch.int32, device=dev)

        self.row_y, self.row_c = zeros(24), zeros(24)
        self.botA_y, self.botB_y, self.botA_c, self.botB_c = (
            zeros(16) for _ in range(4))
        self.out_y = torch.empty((n_waves, 256, l), dtype=torch.uint8,
                                 device=dev)
        self.out_c = torch.empty((n_waves, 128, l), dtype=torch.uint8,
                                 device=dev)

    def edges(self):
        return torch.cat([self.row_y[:, -1], self.row_c[:, -1],
                          self.botB_y[:, 0], self.botA_y[:, 0],
                          self.botB_c[:, 0]])

    def step(self, w, dr0, shtop, left, right, has8x8, haspcm):
        ry = _roll_right(self.row_y, left[_ROW_Y], self.mr) \
            if dr0 == 1 else self.row_y
        rc = _roll_right(self.row_c, left[_ROW_C], self.mr) \
            if dr0 == 1 else self.row_c
        top_row = _roll_left(self.botB_y, right[_BOTB_Y], self.ml) \
            if shtop == 1 else self.botB_y
        tr_row = _roll_left(self.botA_y, right[_BOTA_Y], self.ml) \
            if dr0 == 0 else self.botA_y
        top_c = _roll_left(self.botB_c, right[_BOTB_C], self.ml) \
            if shtop == 1 else self.botB_c
        meta, coefl, coefc, dcs = (f[w] for f in self.feeds)
        tile, ctile, self.row_y, self.row_c, bot_y, bot_c = wave_step(
            ry, rc, top_row, tr_row, top_c, meta, coefl, coefc, dcs,
            self.tables, has8x8=has8x8, haspcm=haspcm)
        self.out_y[w] = tile.to(torch.uint8)
        self.out_c[w] = ctile.to(torch.uint8)
        self.botB_y, self.botA_y = self.botA_y, bot_y
        self.botB_c, self.botA_c = self.botA_c, bot_c


def halo_loop(feeds, ls4, ls8, g, batch, devices, first: int = 0,
              n_strips: int | None = None, exchange=None,
              has8x8: bool = True, haspcm: bool = True):
    """The wave loop over lane strips, in lockstep.

    feeds: (meta_s [W, META_ROWS, L] int32, coefl_s [W, 256, L],
    coefc_s [W, 128, L], dcs_s [W, DC_ROWS, L] int16), the whole lane
    axis L = batch * maxw, on any device.  The L lanes split into
    n_strips contiguous strips (default len(devices)); this call runs
    strips first .. first + len(devices) - 1, strip first + s on
    devices[s].  exchange(buf) -> buf, where given, completes the
    per-wave edge buffer [n_strips + 2, EDGE_LANES] (on devices[0], this
    call's strips' rows filled, every other row zero) with the other
    strips' rows: multihost.py's all_reduce.  Returns this call's lanes
    of (out_y [W, 256, .], out_c [W, 128, .]) uint8 on devices[0]."""
    W, maxw = g["n_waves"], g["maxw"]
    L = batch * maxw
    n = len(devices) if n_strips is None else n_strips
    if L % n:
        raise ValueError(f"lane axis {L} must divide over {n} strips; pad "
                         f"the batch so batch*maxw is a multiple of the "
                         f"mesh axis")
    if exchange is None and (first, len(devices)) != (0, n):
        raise ValueError("strips of other callers need an exchange")
    l = L // n
    dr0s, shtops = wave_schedule(g)
    mr, ml = _seg_masks(maxw, batch)
    strips = [_Strip(feeds, slice((first + s) * l, (first + s + 1) * l),
                     mr, ml, ls4, ls8, W, dev)
              for s, dev in enumerate(devices)]
    hub = devices[0]
    for w in range(W):
        dr0, shtop = int(dr0s[w]), int(shtops[w])
        buf = torch.zeros((n + 2, EDGE_LANES), dtype=torch.int32,
                          device=hub)
        buf[1 + first:1 + first + len(strips)] = torch.stack(
            [st.edges().to(hub) for st in strips])
        if exchange is not None:
            buf = exchange(buf)
        for s, st in enumerate(strips):
            j = 1 + first + s                  # the strip's buffer row
            near = buf[j - 1:j + 2:2].to(st.dev)
            st.step(w, dr0, shtop, near[0], near[1], has8x8, haspcm)
    return (torch.cat([st.out_y.to(hub) for st in strips], 2),
            torch.cat([st.out_c.to(hub) for st in strips], 2))


def _make(wmb, hmb, batch, mesh, axis, has8x8, haspcm):
    """run(device-layout staging [B, W, S, maxw] x 4, ls4, ls8) -> planes:
    the halo over the strips of `mesh[axis]` from this process."""
    g = skew_tables(wmb, hmb)
    g["wmb"], g["hmb"] = wmb, hmb
    L = batch * g["maxw"]
    devices = _strip_devices(mesh, axis)
    if L % len(devices):
        raise ValueError(f"lane axis {L} must divide over {len(devices)} "
                         f"devices; pad the batch so batch*maxw is a "
                         f"multiple of the mesh axis")

    def run(staging, ls4, ls8):
        out_y, out_c = halo_loop(lane_feeds(staging), ls4, ls8, g, batch,
                                 devices, has8x8=has8x8, haspcm=haspcm)
        return unskew_fused(out_y, out_c, g, batch)

    return run, devices[0]


def make_reconstruct_halo(wmb: int, hmb: int, batch: int, mesh,
                          axis: str = "lanes"):
    """(recon, recon_slots): reconstructors whose batch-fused wave-lane
    axis is split over the entries of `mesh[axis]`, single frames
    spanning them, one edge lane of boundary state exchanged per wave.
    recon(arrays, ls4, ls8, cb_off, cr_off) takes raster PackedFrames
    tensors; recon_slots(arrays, luma_slab, chroma_slab, dc_slab, ls4,
    ls8, cb_off, cr_off) the native parser's slot records.  Both return
    (Y, Cb, Cr) uint8 [B, H, W] on the first strip's device."""
    run, _ = _make(wmb, hmb, batch, mesh, axis, True, True)

    def recon(arrays, ls4, ls8, cb_off, cr_off):
        return run(raster_feeds(arrays, cb_off, cr_off, wmb, hmb, batch),
                   ls4, ls8)

    def recon_slots(arrays, luma_slab, chroma_slab, dc_slab, ls4, ls8,
                    cb_off, cr_off):
        arrays = dict(arrays, luma_slab=luma_slab, chroma_slab=chroma_slab,
                      dc_slab=dc_slab)
        return run(records_feeds(arrays, cb_off, cr_off, wmb, hmb, batch),
                   ls4, ls8)

    return recon, recon_slots


def reconstruct_frames_halo(packed: PackedFrames, mesh,
                            axis: str = "lanes"):
    """Reconstruct a PackedFrames batch of any staging layout (raster,
    slot records, device layout) with its lane axis split over
    `mesh[axis]`.  Returns (Y, Cb, Cr) uint8 tensors on the first
    strip's device."""
    run, dev = _make(packed.wmb, packed.hmb, packed.batch, mesh, axis,
                     packed.has8x8, packed.haspcm)
    packed = to_device(packed, dev)
    a = packed.arrays
    if packed.slots == 2:
        staging = device_feeds(a, packed.wmb, packed.hmb)
    else:
        feeds = records_feeds if packed.slots == 1 else raster_feeds
        staging = feeds(a, *packed.chroma_qp_off, packed.wmb, packed.hmb,
                        packed.batch)
    return run(staging, packed.ls4, packed.ls8)

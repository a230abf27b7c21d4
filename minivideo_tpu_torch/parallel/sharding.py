"""Device meshes and batch sharding for scale-out decode.

Port of minivideo_tpu/parallel/sharding.py.  The scale-out model is the
JAX package's:

  * data axis - independent clips/files (embarrassingly parallel);
  * seq axis  - the GOP/time axis within one clip: IDR pictures are
    self-contained (reference filter.c:52), so frames of one clip shard
    cleanly.

Both axes address the same leading batch dimension of PackedFrames (a
frame is (clip, idr_index)); flattening (data, seq) over it gives each
mesh entry a contiguous run of frames, as P(("data", "seq")) does in
JAX.  The LevelScale tables are replicated.

Torch has no virtual devices, so a `Mesh` here is an ndarray of
`torch.device` that may name one device more than once: a 2x2 mesh of
cuda:0 on a one-card host, or of "cpu" in the tests, is the counterpart
of JAX's forced host devices.  Each entry is one shard, and the batch
engines run once per entry on that entry's device.  Importing this
module loads no torch.
"""

from __future__ import annotations

import math

import numpy as np


class Mesh:
    """An ndarray of torch.device with named axes (jax.sharding.Mesh's
    fields: `devices`, `axis_names`, `shape`).  Entries may repeat a
    device."""

    def __init__(self, devices, axis_names):
        import torch
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def make_mesh(n_devices: int | None = None, seq: int | None = None,
              devices=None) -> Mesh:
    """Build a ("data", "seq") mesh over the first n_devices devices
    (default: every CUDA card, cuda:0..n-1; without a card it raises,
    and the CPU is used only when named, e.g. devices=["cpu"] * 8).

    seq defaults to 2 when the device count is even (so single-clip jobs
    with several IDRs still use the whole mesh), else 1."""
    if devices is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; name the mesh's "
                               "devices (e.g. devices=['cpu'] * 4) to run "
                               "on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if seq is None:
        seq = 2 if n % 2 == 0 and n > 1 else 1
    if n % seq != 0:
        raise ValueError(f"seq={seq} does not divide device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // seq, seq), ("data", "seq"))


def pad_to_multiple(arrays: dict, multiple: int):
    """Pad the leading batch dim of every array up to a multiple.

    Padding frames have parsed=0 everywhere, which the reconstruction
    engines treat as "emit zeros": no correctness risk, only bounded
    wasted compute (< one mesh row of frames).

    Returns (padded_arrays, real_batch)."""
    b = next(iter(arrays.values())).shape[0]
    target = int(math.ceil(b / multiple) * multiple)
    if target == b:
        return arrays, b
    out = {}
    for k, v in arrays.items():
        pad = np.zeros((target - b,) + v.shape[1:], dtype=v.dtype)
        out[k] = np.concatenate([np.asarray(v), pad], axis=0)
    return out, b


def shard_frames(arrays: dict, i: int, n: int, dev):
    """Shard i of n of the frame arrays `arrays` as tensors on `dev`: the
    contiguous run of frames that P(("data", "seq")) gives mesh entry i
    in JAX.  A batch that is not a multiple of n comes out as
    pad_to_multiple's would: the last shards end in zero frames, made on
    `dev`, so the host copies no frame.  The copy waits for nothing but
    itself, so each card's shard can be copied from its own thread."""
    import torch
    b = next(iter(arrays.values())).shape[0]
    per = -(-b // n)
    lo, hi = min(i * per, b), min((i + 1) * per, b)
    arrs = {}
    for k, v in arrays.items():
        t = torch.as_tensor(v[lo:hi]).to(dev)
        if hi - lo < per:
            t = torch.cat([t, t.new_zeros((per - (hi - lo),)
                                          + tuple(t.shape[1:]))])
        arrs[k] = t
    return arrs


def shard_packed(mesh: Mesh, arrays: dict, ls4, ls8):
    """Place frame arrays and the replicated tables on the mesh.

    Returns one (arrays, ls4, ls8) per mesh entry, in the mesh's
    row-major order: shard i * seq + j goes to mesh[i, j] (shard_frames);
    ls4 / ls8 are the replicated tables as numpy (the engines copy them
    to each device once).  The JAX module's `batch_sharding` /
    `replicated` descriptors have no counterpart: this placement is the
    only reader they would have."""
    devs = list(mesh.devices.reshape(-1))
    ls4, ls8 = np.asarray(ls4), np.asarray(ls8)
    return [(shard_frames(arrays, i, len(devs), dev), ls4, ls8)
            for i, dev in enumerate(devs)]

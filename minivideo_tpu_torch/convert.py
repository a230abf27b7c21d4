"""Carry a JAX-package batch across to the port.

`packed_from_numpy` turns a `PackedFrames` of the JAX package (any object
with its fields: numpy staging arrays, LevelScale tables ls4/ls8, chroma
QP offsets and flags) into the port's `PackedFrames` with torch tensors
on a given device (the GPU by default), so both packages reconstruct
identical inputs.  The port does not import the JAX package: the object
is read by its fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.recon import PackedFrames

_STAGING = ("meta_slab", "luma_slab", "chroma_slab", "dc_slab")


def packed_from_numpy(packed, device=None) -> PackedFrames:
    """Port PackedFrames over device-layout (v2) staging on `device`
    (default: the GPU, raising where there is none)."""
    if int(packed.slots) != 2:
        raise ValueError("only device-layout (v2) staging carries across")
    device = resolve_device(device)
    arrays = {k: torch.as_tensor(np.ascontiguousarray(packed.arrays[k]),
                                 device=device) for k in _STAGING}
    return PackedFrames(int(packed.wmb), int(packed.hmb), arrays,
                        np.asarray(packed.ls4, np.int32),
                        np.asarray(packed.ls8, np.int32),
                        tuple(int(v) for v in packed.chroma_qp_off),
                        has8x8=bool(packed.has8x8))

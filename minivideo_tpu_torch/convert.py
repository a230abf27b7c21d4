"""Carry a JAX-package batch across to the port.

`packed_from_numpy` turns a `PackedFrames` of the JAX package (any object
with its fields: numpy staging arrays of any of the three layouts, the
layout number `slots`, LevelScale tables ls4/ls8, chroma QP offsets and
flags) into the port's `PackedFrames` with torch tensors on a given device
(the GPU by default), so both packages reconstruct identical inputs.  The
port does not import the JAX package: the object is read by its fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.recon import PackedFrames


def packed_from_numpy(packed, device=None) -> PackedFrames:
    """Port PackedFrames over the same staging (raster, slot records or
    device layout) on `device` (default: the GPU, raising where there is
    none)."""
    slots = int(packed.slots)
    if slots not in (0, 1, 2):
        raise ValueError(f"unknown staging layout slots={slots}")
    device = resolve_device(device)
    arrays = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
              for k, v in packed.arrays.items()}
    return PackedFrames(int(packed.wmb), int(packed.hmb), arrays,
                        np.asarray(packed.ls4, np.int32),
                        np.asarray(packed.ls8, np.int32),
                        tuple(int(v) for v in packed.chroma_qp_off),
                        slots=slots, has8x8=bool(packed.has8x8))

"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

Both packages get the same numpy inputs: a stream made by the fixture
encoder is parsed by the JAX package into staging (the device layout, or
the records or raster layout), and
`minivideo_tpu_torch.convert.packed_from_numpy` carries that staging to
the port, so any difference in the pictures is a difference of the
reconstruction.

Two rules keep the port's tests from disturbing the JAX package's.
test_containers.py's bounded-memory test reads the peak RSS of a
subprocess, which inherits the pytest worker's (~160 MB more once torch
is imported, over its 300 MB bound):
  * test files import torch and minivideo_tpu_torch inside the tests or
    fixtures, never at module level, because every xdist worker imports
    every test module while collecting;
  * each tests/test_torch_*.py file holds 18 collected tests or fewer:
    loadfile mode hands out the files with the most tests first, so
    test_containers.py (18 tests) still starts on a fresh worker.
"""

import numpy as np

from minivideo_tpu.models.h264.decoder import (H264Decoder,
                                               group_idr_access_units)
from minivideo_tpu.models.h264.nalu import parse_nalu, split_annexb
from minivideo_tpu.models.h264.slicehdr import parse_slice_header


def jax_packed(data, staging_mode="device"):
    """JAX-package PackedFrames over slab staging (v2 device layout by
    default) for every IDR picture of `data` (one SPS/PPS), with the
    picture syntax and parameter sets."""
    dec = H264Decoder()
    nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
    for n in nalus:
        if n.nal_unit_type in (7, 8):
            dec.feed_nalu(n)
    groups = group_idr_access_units(nalus)
    first = groups[0][0]
    _, sps, pps = parse_slice_header(first.rbsp, first.nal_unit_type,
                                     first.nal_ref_idc, dec.sps_map,
                                     dec.pps_map)
    packed, frames = dec.parse_groups_slab(groups, sps, pps,
                                           staging_mode=staging_mode)
    return packed, frames, sps, pps


def jax_staging(data, layout):
    """JAX-package PackedFrames of every IDR picture of `data` (one
    SPS/PPS) in staging `layout`: "raster" (its parse_idr_syntax, then
    pack_frames), "records" or "device" (its native slab parses)."""
    from minivideo_tpu.ops.recon import pack_frames
    if layout != "raster":
        return jax_packed(data, layout)[0]
    dec = H264Decoder()
    nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
    for n in nalus:
        if n.nal_unit_type in (7, 8):
            dec.feed_nalu(n)
    parsed = [dec.parse_idr_syntax(g) for g in group_idr_access_units(nalus)]
    _, sps, pps, _ = parsed[0]
    return pack_frames([(fs, som) for fs, _, _, som in parsed], sps, pps)


def assert_planes_equal(want, got, what=""):
    """Pictures are integers: equal, bit for bit (tolerance 0)."""
    for name, a, b in zip(("Y", "Cb", "Cr"), want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{what} {name}: {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")

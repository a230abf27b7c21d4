"""The plain reference decoder: one IDR picture of an Annex-B stream to its
uncropped (Y, Cb, Cr) planes, in Python and NumPy alone.

It runs the frozen copies in `h264/`: the Python CAVLC and CABAC slice
parsers and the numpy oracle of the reconstruction (spec 8.3-8.5, exact
integer arithmetic).  It imports nothing of the program under test.

`control=True` runs the same decoder with the inverse core transforms
(spec 8.5.12.2 and 8.5.13.2) computed in float32 and rounded, in place of
the standard's integer arithmetic: the precision step a faster transform
would be tempted to take.  Its pictures are the control that the
comparison has to fail.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .h264 import recon_np
from .h264.bitio import BitReader
from .h264.cabac import CabacSliceParser
from .h264.expgolomb import read_ue
from .h264.nalu import NaluType, parse_nalu, split_annexb
from .h264.params import parse_pps, parse_sps
from .h264.slicehdr import parse_slice_header
from .h264.syntax import CavlcSliceParser, FrameSyntax

# the inverse core transforms as matrices (spec 8-338..8-341, 8-347..)
_T4 = np.array([[1, 1, 1, 0.5], [1, 0.5, -1, -1], [1, -0.5, -1, 1],
                [1, -1, 1, -0.5]], dtype=np.float32)
_T8 = np.array([[8, 12, 8, 10, 8, 6, 4, 3], [8, 10, 4, -3, -8, -12, -8, -6],
                [8, 6, -4, -12, -8, 3, 8, 10], [8, 3, -8, -6, 8, 10, -4, -12],
                [8, -3, -8, 6, 8, -10, -4, 12], [8, -6, -4, 12, -8, -3, 8, -10],
                [8, -10, 4, 3, -8, 12, -8, 6], [8, -12, 8, -10, 8, -6, 4, -3]],
               dtype=np.float32) / 8


def _idct_4x4_float(d):
    d = np.asarray(d, dtype=np.float32)
    return np.round((_T4 @ d @ _T4.T) / 64).astype(np.int64)


def _idct_8x8_float(d):
    d = np.asarray(d, dtype=np.float32)
    return np.round((_T8 @ d @ _T8.T) / 64).astype(np.int64)


def picture_groups(stream: bytes):
    """(SPS map, PPS map, [[IDR slice Nalu, ...] per picture]): a new
    picture starts where first_mb_in_slice is 0."""
    sps_map, pps_map, groups = {}, {}, []
    for off, raw in split_annexb(stream):
        n = parse_nalu(raw, off)
        t = n.nal_unit_type
        if t == NaluType.SPS:
            sps = parse_sps(n.rbsp)
            sps_map[sps.seq_parameter_set_id] = sps
        elif t == NaluType.PPS:
            pps = parse_pps(n.rbsp, sps_map)
            pps_map[pps.pic_parameter_set_id] = pps
        elif t == NaluType.SLICE_IDR:
            if read_ue(BitReader(n.rbsp)) == 0 or not groups:
                groups.append([])
            groups[-1].append(n)
    return sps_map, pps_map, groups


def decode_picture(stream: bytes, index: int, control: bool = False):
    """Picture `index` (0 = the first IDR picture) of `stream`:
    ((Y, Cb, Cr) uncropped uint8, (display width, display height))."""
    sps_map, pps_map, groups = picture_groups(stream)
    fs = slice_of_mb = None
    for snum, n in enumerate(groups[index]):
        sh, sps, pps = parse_slice_header(n.rbsp, n.nal_unit_type,
                                          n.nal_ref_idc, sps_map, pps_map)
        if fs is None:
            fs = FrameSyntax(sps.pic_width_in_mbs,
                             sps.pic_height_in_map_units)
            slice_of_mb = np.full(fs.n_mbs, -1, dtype=np.int32)
        if pps.entropy_coding_mode_flag:
            parser = CabacSliceParser(n.rbsp, sh, sps, pps, fs)
        else:
            parser = CavlcSliceParser(
                BitReader(n.rbsp, start_bit=sh.data_bit_offset), sh, sps,
                pps, fs)
        k = parser.parse_slice_data()
        slice_of_mb[sh.first_mb_in_slice:sh.first_mb_in_slice + k] = snum
    saved = recon_np.idct_4x4, recon_np.idct_8x8
    if control:
        recon_np.idct_4x4, recon_np.idct_8x8 = (_idct_4x4_float,
                                                _idct_8x8_float)
    try:
        planes = recon_np.reconstruct_frame(fs, sps, pps, slice_of_mb)
    finally:
        recon_np.idct_4x4, recon_np.idct_8x8 = saved
    return planes, (sps.cropped_width, sps.cropped_height)


def planes_sha256(y, cb, cr) -> str:
    """One SHA-256 over Y, Cb and Cr, in that order."""
    h = hashlib.sha256()
    for p in (y, cb, cr):
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def cropped(planes, size):
    """The display-cropped planes (4:2:0) of uncropped `planes`."""
    (y, cb, cr), (w, h) = planes, size
    return y[:h, :w], cb[:h // 2, :w // 2], cr[:h // 2, :w // 2]

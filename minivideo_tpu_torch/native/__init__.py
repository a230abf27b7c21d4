"""ctypes binding of the native entropy parser (src/entropy.cc).

The library is built from the sources in this package at first use
(`g++ -O3 -fPIC -shared -std=c++17 -pthread`, see _build.py) and loaded
from the package's ignored build directory; a failed build raises.  Only
the device-layout slab parse (`mv_parse_slice_slab2`) is bound: it fills
the lite FrameSyntax arrays and the fused engine's per-wave feeds.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .._build import build_shared
from ..bitio import BitstreamError

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "entropy.cc")
_lib = None


def _cmd(out, sources):
    return ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
            "-o", out, *sources]


def build() -> str:
    """Compile the parser if its build is missing; returns the .so path."""
    return build_shared("mvt_entropy", [_SRC], _cmd)


def load():
    """Load (building if needed) the native parser library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.mv_parse_slice_slab2.restype = ctypes.c_int64
    lib.mv_parse_slice_slab2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    _lib = lib
    return lib


# buffer order must match entropy.cc's mv_parse_slice
_FIELDS = ("mb_kind", "qpy", "i16_mode", "chroma_mode", "luma4x4_modes",
           "luma8x8_modes", "cbp_luma", "cbp_chroma", "luma_dc", "luma_ac",
           "luma8x8_coeff", "chroma_dc", "chroma_ac", "total_coeff_luma",
           "total_coeff_chroma", "cbf_luma_dc", "cbf_luma", "cbf_luma8x8",
           "cbf_chroma_dc", "cbf_chroma", "transform8x8", "parsed")


def parse_slice_native_slab2(fs, slabs, i: int, rbsp: bytes,
                             data_bit_offset: int, first_mb: int,
                             slice_qp: int, entropy_cabac: bool,
                             transform8x8_mode: bool,
                             cb_qp_off: int = 0,
                             cr_qp_off: int = 0) -> int:
    """Device-layout slab parse of one I slice: coefficients land in
    `slabs` (ops.recon.make_slab_staging2) at frame row `i` as the fused
    engine's per-wave feeds [W, S, maxw], together with the meta rows
    [W, 40, maxw] int32.  Returns the slice's MB count; raises
    BitstreamError on a parse error."""
    lib = load()
    bufs = (ctypes.c_void_p * (len(_FIELDS) + 4))()
    for j, name in enumerate(_FIELDS):
        arr = getattr(fs, name)
        assert isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]
        bufs[j] = arr.ctypes.data_as(ctypes.c_void_p).value
    for j, name in enumerate(("luma_slab", "chroma_slab", "dc_slab",
                              "meta_slab")):
        arr = slabs[name][i]
        want = np.int32 if name == "meta_slab" else np.int16
        assert arr.dtype == want and arr.flags["C_CONTIGUOUS"]
        bufs[len(_FIELDS) + j] = arr.ctypes.data_as(ctypes.c_void_p).value
    n = lib.mv_parse_slice_slab2(
        rbsp, len(rbsp), data_bit_offset,
        fs.width_mbs, fs.height_mbs, first_mb, slice_qp,
        1 if entropy_cabac else 0, 1 if transform8x8_mode else 0,
        slabs["maxw"], 1, 0, cb_qp_off, cr_qp_off, bufs)
    if n < 0:
        raise BitstreamError(f"native slab2 slice parse failed (code {n})")
    return int(n)

"""ctypes bindings of the native host libraries: the entropy parser
(src/entropy.cc), the demuxer (src/demux.cc, bound by
containers/native.py) and the picture encoders (src/export.cc, bound
here for export/image.py).

Each is built from the sources in this package at first use, as its own
library, with the JAX package's Makefile flags (`cxx_argv`; _build.py),
and loaded from the package's ignored build directory; a failed build
raises.  Where MINIVIDEO_TPU_TORCH_NATIVE_LIB names a library that holds
all three sources (tools/asan_check_torch.sh builds one with
AddressSanitizer), every loader loads that one and builds nothing; a
path that does not exist raises.  Three parses are bound, one per
staging layout of ops/recon.py: `parse_slice_native` (raster: the full
FrameSyntax arrays, a drop-in for the Python parsers),
`parse_slice_native_slab` (slot records) and `parse_slice_native_slab2`
(the device mode's MB-major records, with the meta rows).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from .._build import build_shared
from ..bitio import BitstreamError
from ..models.h264.syntax import KIND_IPCM

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "entropy.cc")
_DEMUX_SRC = os.path.join(os.path.dirname(_SRC), "demux.cc")
_EXPORT_SRC = os.path.join(os.path.dirname(_SRC), "export.cc")
_lib = None
_demux_lib = None
_export_lib = None


# The device staging mode's MB-major records (src/entropy.cc kRec*): one
# int16 record per macroblock, in raster order, written whole by
# parse_slice_native_slab2: the luma [256], chroma [128] and DC [32] slabs
# of ops/slab.py, then its META_ROWS rows 0..33 (rows 34..39 are zero),
# zero padding to whole 32-byte sectors.  ops/wave_layout.py lays them out
# into the wave kernel's per-wave feeds.
REC_LUMA, REC_CHROMA, REC_DC, REC_META = 0, 256, 384, 416
REC_META_ROWS = 34
REC_LEN = 464           # 928 B

# the one library that replaces all three builds (read at first load)
OVERRIDE_ENV = "MINIVIDEO_TPU_TORCH_NATIVE_LIB"


@functools.lru_cache(maxsize=None)
def _march() -> list:
    """["-march=native"] where the compiler takes it, else [] (the JAX
    package's Makefile test, minivideo_tpu/native/Makefile)."""
    r = subprocess.run(["g++", "-march=native", "-E", "-x", "c", os.devnull],
                       capture_output=True, timeout=60)
    return ["-march=native"] if r.returncode == 0 else []


def cxx_argv(out, sources, libs=()) -> list:
    """The g++ argv that builds `sources` into the shared library `out`,
    with the flags of minivideo_tpu/native/Makefile (-march=native where
    g++ takes it: BMI2 SHLX matters for the CABAC engine's variable
    shifts).  One argv for the three libraries and the lint
    (tools/lint_torch.sh)."""
    return ["g++", "-O3", *_march(), "-fPIC", "-std=c++17", "-pthread",
            "-Wall", "-Wextra", "-Wno-unused-parameter", "-shared",
            "-o", out, *sources, *libs]


def libraries() -> dict:
    """Library name -> (sources, link libraries) of the three builds."""
    return {"mvt_entropy": ([_SRC], []),
            "mvt_demux": ([_DEMUX_SRC], []),
            "mvt_export": ([_EXPORT_SRC], ["-lz"])}


def _build(name) -> str:
    sources, libs = libraries()[name]
    return build_shared(name, sources,
                        lambda out, srcs: cxx_argv(out, srcs, libs))


def build() -> str:
    """Compile the parser if its build is missing; returns the .so path."""
    return _build("mvt_entropy")


def build_demux() -> str:
    """Compile the demuxer if its build is missing; returns the .so path."""
    return _build("mvt_demux")


def build_export() -> str:
    """Compile the picture encoders (with zlib) if their build is
    missing; returns the .so path."""
    return _build("mvt_export")


@functools.lru_cache(maxsize=None)
def _override_lib(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{OVERRIDE_ENV}={path}: no such library")
    return ctypes.CDLL(path)


def _open(build_fn):
    """The override library where OVERRIDE_ENV is set (one CDLL for every
    loader), else `build_fn()`'s library."""
    path = os.environ.get(OVERRIDE_ENV)
    return _override_lib(path) if path else ctypes.CDLL(build_fn())


def load_demux():
    """Load (building if needed) the native demuxer library."""
    global _demux_lib
    if _demux_lib is None:
        _demux_lib = _open(build_demux)
    return _demux_lib


def load_export():
    """Load (building if needed) the picture-encoder library."""
    global _export_lib
    if _export_lib is not None:
        return _export_lib
    lib = _open(build_export)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.c_int32
    lib.mv_yuv420_to_rgb.restype = None
    lib.mv_yuv420_to_rgb.argtypes = [u8p, u8p, u8p, i32, i32, i32, i32,
                                     u8p]
    lib.mv_encode_jpeg.restype = ctypes.c_int64
    lib.mv_encode_jpeg.argtypes = [u8p, u8p, u8p, i32, i32, i32, i32,
                                   i32, u8p, ctypes.c_int64]
    lib.mv_encode_png.restype = ctypes.c_int64
    lib.mv_encode_png.argtypes = [u8p, i32, i32, i32, i32, u8p,
                                  ctypes.c_int64]
    for enc in (lib.mv_encode_bmp, lib.mv_encode_tga):
        enc.restype = ctypes.c_int64
        enc.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, u8p,
                        ctypes.c_int64]
    _export_lib = lib
    return lib


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _c(arr):
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"expected uint8 samples, got {a.dtype}")
    return a


def yuv420_to_rgb_native(y, cb, cr) -> np.ndarray:
    """Planar 4:2:0 -> interleaved RGB888 (integer BT.601; bit-exact with
    export/image.py yuv420_to_rgb_py — the reference's mb_to_rgb math,
    export_utils.c:297-304)."""
    lib = load_export()
    y, cb, cr = _c(y), _c(cb), _c(cr)
    h, w = y.shape
    ch, cw = cb.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.mv_yuv420_to_rgb(_u8p(y), _u8p(cb), _u8p(cr), h, w, ch, cw,
                         _u8p(out))
    return out


def encode_jpeg_native(y, cb, cr, quality: int = 75) -> bytes:
    """Baseline JPEG (4:2:0) straight from decoded planes; C-speed
    equivalent of the reference's libjpeg path (export.c:341-445)."""
    lib = load_export()
    y, cb, cr = _c(y), _c(cb), _c(cr)
    h, w = y.shape
    ch, cw = cb.shape
    cap = h * w * 3 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.mv_encode_jpeg(_u8p(y), _u8p(cb), _u8p(cr), h, w, ch, cw,
                           quality, _u8p(out), cap)
    if n < 0:
        raise RuntimeError(f"native JPEG encode failed (code {n})")
    return out[:n].tobytes()


def encode_png_native(rgb, level: int = 3, threads: int = 0) -> bytes:
    """PNG RGB8: per-row sub filtering + banded parallel deflate (raw
    bands joined at Z_FULL_FLUSH byte boundaries, adler32_combine
    trailer).  threads=0 = one band per hardware thread, so the bytes
    (not the pixels) depend on the host's thread count.  Reference:
    export.c:447-551 (libpng/stb single-thread writers)."""
    lib = load_export()
    rgb = _c(rgb)
    h, w, _ = rgb.shape
    cap = h * (w * 3 + 1) + (h * w // 100) + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.mv_encode_png(_u8p(rgb), h, w, level, threads, _u8p(out),
                          cap)
    if n < 0:
        raise RuntimeError(f"native PNG encode failed (code {n})")
    return out[:n].tobytes()


def encode_bmp_native(rgb) -> bytes:
    lib = load_export()
    rgb = _c(rgb)
    h, w, _ = rgb.shape
    cap = 54 + (w * 3 + 3) // 4 * 4 * h
    out = np.empty(cap, np.uint8)
    n = lib.mv_encode_bmp(_u8p(rgb), h, w, _u8p(out), cap)
    if n < 0:
        raise RuntimeError(f"native BMP encode failed (code {n})")
    return out[:n].tobytes()


def encode_tga_native(rgb) -> bytes:
    lib = load_export()
    rgb = _c(rgb)
    h, w, _ = rgb.shape
    cap = 18 + h * w * 3
    out = np.empty(cap, np.uint8)
    n = lib.mv_encode_tga(_u8p(rgb), h, w, _u8p(out), cap)
    if n < 0:
        raise RuntimeError(f"native TGA encode failed (code {n})")
    return out[:n].tobytes()


def load():
    """Load (building if needed) the native parser library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _open(build)
    lib.mv_parse_slice.restype = ctypes.c_int64
    lib.mv_parse_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.mv_parse_slice_slab.restype = ctypes.c_int64
    lib.mv_parse_slice_slab.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.mv_parse_slice_slab2.restype = ctypes.c_int64
    lib.mv_parse_slice_slab2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.mv_record_len.restype = ctypes.c_int32
    lib.mv_record_len.argtypes = []
    if lib.mv_record_len() != REC_LEN:
        raise RuntimeError(f"native records of {lib.mv_record_len()} "
                           f"elements, REC_LEN {REC_LEN}")
    lib.mv_cabac_bins_total.restype = ctypes.c_uint64
    lib.mv_cabac_bins_total.argtypes = []
    _lib = lib
    return lib


def cabac_bins_total() -> int:
    """Total CABAC bins decoded by the native parser in this process (all
    threads); sample a delta around a workload for bins per picture."""
    return int(load().mv_cabac_bins_total())


# buffer order must match entropy.cc's mv_parse_slice
_FIELDS = ("mb_kind", "qpy", "i16_mode", "chroma_mode", "luma4x4_modes",
           "luma8x8_modes", "cbp_luma", "cbp_chroma", "luma_dc", "luma_ac",
           "luma8x8_coeff", "chroma_dc", "chroma_ac", "total_coeff_luma",
           "total_coeff_chroma", "cbf_luma_dc", "cbf_luma", "cbf_luma8x8",
           "cbf_chroma_dc", "cbf_chroma", "transform8x8", "parsed")


def _field_bufs(fs, extra: int):
    """ctypes pointer array over fs's _FIELDS buffers, with `extra` slots
    left for the staging pointers."""
    bufs = (ctypes.c_void_p * (len(_FIELDS) + extra))()
    for j, name in enumerate(_FIELDS):
        arr = getattr(fs, name)
        assert isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]
        bufs[j] = arr.ctypes.data_as(ctypes.c_void_p).value
    return bufs


def parse_slice_native(fs, rbsp: bytes, data_bit_offset: int,
                       first_mb: int, slice_qp: int, entropy_cabac: bool,
                       transform8x8_mode: bool) -> int:
    """Parse one I slice into the (full, not lite) FrameSyntax `fs`, as
    the Python parsers do.  Returns the slice's MB count; raises
    BitstreamError on a parse error, like the Python parsers, so the
    decoder's error count treats both alike."""
    lib = load()
    assert not fs.lite, "the raster parse needs full coefficient buffers"
    bufs = _field_bufs(fs, 0)
    n = lib.mv_parse_slice(
        rbsp, len(rbsp), data_bit_offset,
        fs.width_mbs, fs.height_mbs, first_mb, slice_qp,
        1 if entropy_cabac else 0, 1 if transform8x8_mode else 0, bufs)
    if n < 0:
        raise BitstreamError(f"native slice parse failed (code {n})")
    # I_PCM macroblocks: the parser stored their raw samples in the
    # coefficient buffers; mirror them into the FrameSyntax dicts, where
    # the Python parsers put them
    for mb in np.nonzero(fs.mb_kind == KIND_IPCM)[0]:
        mb = int(mb)
        if mb in fs.pcm_y:
            continue
        fs.pcm_y[mb] = fs.luma_ac[mb].reshape(16, 16).astype(np.uint8)
        c = fs.chroma_ac[mb].reshape(2, 8, 8).astype(np.uint8)
        fs.pcm_cb[mb] = c[0]
        fs.pcm_cr[mb] = c[1]
    return int(n)


def parse_slice_native_slab(fs, slabs, i: int, rbsp: bytes,
                            data_bit_offset: int, first_mb: int,
                            slice_qp: int, entropy_cabac: bool,
                            transform8x8_mode: bool) -> int:
    """Slot-record parse of one I slice: coefficients land in `slabs`
    (ops.recon.make_slab_staging) at batch row `i` as int16 records in
    skew-slot order, and the per-MB metadata fills the lite `fs`.
    Returns the slice's MB count; raises BitstreamError on a parse
    error."""
    lib = load()
    bufs = _field_bufs(fs, 3)
    for j, name in enumerate(("luma_slab", "chroma_slab", "dc_slab")):
        arr = slabs[name][i]
        assert arr.dtype == np.int16 and arr.flags["C_CONTIGUOUS"]
        bufs[len(_FIELDS) + j] = arr.ctypes.data_as(ctypes.c_void_p).value
    n = lib.mv_parse_slice_slab(
        rbsp, len(rbsp), data_bit_offset,
        fs.width_mbs, fs.height_mbs, first_mb, slice_qp,
        1 if entropy_cabac else 0, 1 if transform8x8_mode else 0,
        slabs["maxw"], bufs)
    if n < 0:
        raise BitstreamError(f"native slab slice parse failed (code {n})")
    return int(n)


def parse_slice_native_slab2(fs, staging, i: int, rbsp: bytes,
                             data_bit_offset: int, first_mb: int,
                             slice_qp: int, entropy_cabac: bool,
                             transform8x8_mode: bool,
                             cb_qp_off: int = 0,
                             cr_qp_off: int = 0) -> int:
    """Device-mode parse of one I slice: each macroblock it parses is
    written whole, coefficients and meta rows, as one int16 record
    (REC_* above) at its raster index of `staging["records"][i]`
    (ops.recon.make_slab_staging2), so the records need no zeroing
    first; the per-MB metadata also fills the lite `fs`.  Returns the
    slice's MB count; raises BitstreamError on a parse error (the MBs
    parsed before it are written, the one that failed is not)."""
    lib = load()
    bufs = _field_bufs(fs, 1)
    arr = staging["records"][i]
    assert arr.dtype == np.int16 and arr.flags["C_CONTIGUOUS"]
    assert arr.shape == (fs.n_mbs, REC_LEN)
    bufs[len(_FIELDS)] = arr.ctypes.data_as(ctypes.c_void_p).value
    n = lib.mv_parse_slice_slab2(
        rbsp, len(rbsp), data_bit_offset,
        fs.width_mbs, fs.height_mbs, first_mb, slice_qp,
        1 if entropy_cabac else 0, 1 if transform8x8_mode else 0,
        cb_qp_off, cr_qp_off, bufs)
    if n < 0:
        raise BitstreamError(f"native slab2 slice parse failed (code {n})")
    return int(n)

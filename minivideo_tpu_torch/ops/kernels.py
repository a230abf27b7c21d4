"""The port's CUDA library: every kernel under csrc/, one shared object.

`build()` compiles each csrc/*.cu for sm_90a with its own `nvcc`
process, all started together, and links them into one library in the
package's ignored `_build/`; `load()` binds its C launchers with ctypes.
Both run on first use, never at import: the CPU tests import every module
on a machine without nvcc.  A failed build raises.  Extra `defines` build
a separate library (ops/wave_phases.py passes -DMVT_PHASES); the package
itself loads the library as it ships.
"""

from __future__ import annotations

import ctypes
import os

from .._build import build_shared

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = [os.path.join(CSRC, f) for f in ("wave_kernel.cu",
                                             "wave_layout_kernel.cu",
                                             "interleave_kernel.cu")]
NAME = "mvt_kernels"
_libs: dict = {}


def _nvcc():
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def compile_argv(src, obj, defines=()) -> list:
    """The nvcc argv that compiles one csrc/*.cu into the object `obj`
    (the build's and the lint's, tools/lint_torch.sh)."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
            "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *defines, "-c", "-o", obj, src]


def _compile(defines):
    return lambda src, obj: compile_argv(src, obj, defines)


def _link(out, objects):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", out, *objects]


def build(defines=()) -> str:
    """Compile and link csrc/*.cu for sm_90a if the build is missing."""
    return build_shared(NAME, SOURCES, _link, compile_cmd=_compile(defines))


def load(defines=()):
    """The loaded library, built first if needed."""
    defines = tuple(defines)
    if defines not in _libs:
        lib = ctypes.CDLL(build(defines))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mvt_wave_run.restype = ci
        lib.mvt_wave_run.argtypes = [vp] * 12 + [ci] * 7 + [vp]
        lib.mvt_layout_run.restype = ci
        lib.mvt_layout_run.argtypes = [vp] * 6 + [ci] * 4 + [vp]
        lib.mvt_interleave_run.restype = ci
        lib.mvt_interleave_run.argtypes = [vp, vp, ci, ci, ci, vp]
        _libs[defines] = lib
    return _libs[defines]

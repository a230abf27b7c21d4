"""Runtime settings of the port (minivideo_tpu/settings.py): the
engines, the host's endianness, the library's info dump, and the
staging-layout choice.

Not ported: the JAX module's `Settings` snapshot (`settings()`,
`from_env`), whose engine, profile and color knobs nothing in the port
reads; `get_infos` reads the two switches the port has
(MINIVIDEO_TPU_TRACE, MINIVIDEO_TPU_NO_NATIVE) where it is called, as
the tracer and the demuxer/decoder do.  Nor `ensure_compile_cache`,
which points JAX at its persistent XLA compile cache; the port compiles
its libraries once per checkout into `_build/` (_build.py), and has no
XLA cache to wire.

The decoder stages a batch in one of two layouts (ops/recon.py): "records"
(slot records; sparse host writes into zeroed staging, a feed transpose
and the meta build on the card) or "device" (one MB-major record per
macroblock with its meta rows, written whole by the parser; a copy of
half the bytes and one layout kernel on the card).  The pipe moves at the
slower of the host parse and the card's drain, so the better layout can
depend on the host's core count (with the constants below, the records
layout below 8 cores and the device layout from 8).  The four constants
are measured on the card's host by chip_smoke.py's staging phase, which
prints them, on the 1080p CAVLC batch of 16 (testing/streams.
STREAM_1080P); refresh them from several runs when the parser, the feeds
or the kernel change.
"""

from __future__ import annotations

import os
import sys

VERSION = (0, 5, 0)          # the JAX package's version
VERSION_STR = ".".join(str(v) for v in VERSION)

# reconstruction engines, as in the JAX package: the fused wave engine
# (the CUDA kernel on a GPU, its plain PyTorch version on the CPU; the
# port's default), the wave loop (torch ops on the decode's device) and
# the numpy oracle (host)
ENGINES = ("fused", "wave", "np")


# Measured by chip_smoke.py's staging phase on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (nvidia-smi), on a host with 8 cores, with the
# device mode's MB-major records and their layout kernel: each constant
# the median of three runs of the same code (one run moves them by up to
# a quarter).
# native parse, ms per picture on one core (one thread), per layout
HOST_MS_RECORDS = 24.7201
HOST_MS_DEVICE = 26.4864
# pictures/s of everything after the parse (staging copy, feeds, kernel)
DEVICE_FPS_RECORDS = 267.4549
DEVICE_FPS_DEVICE = 779.7771


def staging_throughput(cores: int, mode: str) -> float:
    """Modelled end-of-pipe pictures/s: the host feed (cores x measured
    per-core rate) and the card's drain run concurrently, so the pipe
    moves at the slower of the two."""
    if mode == "device":
        return min(cores * 1000.0 / HOST_MS_DEVICE, DEVICE_FPS_DEVICE)
    return min(cores * 1000.0 / HOST_MS_RECORDS, DEVICE_FPS_RECORDS)


def staging_mode() -> str:
    """Slab staging layout for the native parse: "records" or "device"
    (see decoder.H264Decoder.parse_groups_slab).

    MINIVIDEO_TPU_STAGING overrides; "auto" (the default) picks the layout
    with the higher modelled throughput for this host's core count
    (staging_throughput; the device layout where they tie)."""
    mode = os.environ.get("MINIVIDEO_TPU_STAGING", "auto")
    if mode in ("records", "device"):
        return mode
    if mode != "auto":
        raise ValueError(
            f"MINIVIDEO_TPU_STAGING={mode!r}: expected 'records', "
            f"'device' or 'auto'")
    cores = os.cpu_count() or 1
    return max(("device", "records"),
               key=lambda m: staging_throughput(cores, m))


def endianness() -> int:
    """4321 for little-endian hosts, 1234 for big-endian (the reference's
    minivideo_endianness contract, minivideo.c:159-199)."""
    return 4321 if sys.byteorder == "little" else 1234


def get_infos() -> dict:
    """Version + feature flags (reference minivideo_get_infos,
    minivideo.c:140-156): the JAX package's keys, with "torch" in place
    of "jax" and the CUDA cards as "devices".  The native libraries are
    built at first use and a failed build raises, so "native_runtime"
    is whether MINIVIDEO_TPU_NO_NATIVE leaves the native paths on now.
    "engine" is the default engine, "fused"; the port decodes I_PCM and
    colors its traces on a terminal, so those keys are constants."""
    import torch
    return {
        "version": VERSION_STR,
        "version_major": VERSION[0],
        "version_minor": VERSION[1],
        "version_patch": VERSION[2],
        "python": sys.version.split()[0],
        "endianness": endianness(),
        "traces": bool(os.environ.get("MINIVIDEO_TPU_TRACE")),
        "colors": True,
        "native_runtime": os.environ.get("MINIVIDEO_TPU_NO_NATIVE") != "1",
        "engine": ENGINES[0],
        "ipcm": True,
        "torch": torch.__version__,
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
    }


def print_infos(file=None) -> None:
    """Human-readable settings dump (reference minivideo_print_infos,
    minivideo.c:59-137)."""
    f = file or sys.stdout
    for k, v in get_infos().items():
        print(f"* {k}: {v}", file=f)

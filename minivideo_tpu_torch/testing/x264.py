"""libx264 streams and libavcodec's pictures of them: real-encoder input
for the bench (bench.py) and the parity tests, from a second codebase.

The repo's C tools over libavcodec, `tools/x264_fixture.c` (libx264
all-IDR streams: constant QP, no deblocking, in-band parameter sets),
`tools/h264_lavc_decode.c` (libavcodec's h264 decoder, raw planes out)
and `tools/lavf_ps_mux.c` (libavformat's "vob" muxer), are built
with gcc at first use into the package's ignored `_build/` (_build.py).
Where the host lacks libavcodec's headers or libraries the build raises
RuntimeError; callers that can do without a real encoder (the bench
falls back to testing/h264enc2.py) catch exactly that.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

from .._build import build_shared

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tools")


def _tool(name: str, libs=("-lavcodec", "-lavutil")) -> str:
    src = os.path.join(TOOLS, f"{name}.c")
    if not os.path.exists(src):
        raise RuntimeError(f"{src} is missing (not a checkout of the repo)")
    return build_shared(
        f"mvt_{name}", [src], lambda out, srcs: [
            "gcc", "-O2", *srcs, "-o", out, *libs],
        binary=True)


def encoder() -> str:
    """Path of the built x264 fixture encoder (raises without libav)."""
    return _tool("x264_fixture")


def decoder() -> str:
    """Path of the built libavcodec decoder (raises without libav)."""
    return _tool("h264_lavc_decode")


def ps_muxer() -> str:
    """Path of the built libavformat program-stream muxer
    (tools/lavf_ps_mux.c; raises without libavformat)."""
    return _tool("lavf_ps_mux", ("-lavformat", "-lavcodec", "-lavutil"))


def lavf_ps(data: bytes) -> bytes:
    """`data` (Annex-B) muxed into MPEG-PS by libavformat's "vob" muxer:
    2,048-byte packs that ignore access unit boundaries."""
    exe = ps_muxer()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.264")
        dst = os.path.join(tmp, "out.mpg")
        with open(src, "wb") as f:
            f.write(data)
        r = subprocess.run([exe, src, dst], capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"lavf_ps_mux failed: {r.stderr[-300:]}")
        with open(dst, "rb") as f:
            return f.read()


def x264_stream(w, h, frames, qp, cabac, dct8, seed, slices=1,
                noise=None) -> bytes:
    """A libx264 Annex-B stream of `frames` IDR pictures, w x h luma
    samples (x264_fixture.c's arguments; noise=None keeps its default
    noise mask)."""
    exe = encoder()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "x264.264")
        argv = [exe, out, str(w), str(h), str(frames), str(qp),
                str(int(cabac)), str(int(dct8)), str(seed), str(slices)]
        if noise is not None:
            argv.append(str(noise))
        r = subprocess.run(argv, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"x264_fixture failed: {r.stderr[-500:]}")
        with open(out, "rb") as f:
            return f.read()


def lavc_decode(data: bytes):
    """libavcodec's display-cropped pictures of `data`: [(Y, Cb, Cr)]
    uint8 planes."""
    exe = decoder()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.264")
        dst = os.path.join(tmp, "out.yuv")
        with open(src, "wb") as f:
            f.write(data)
        r = subprocess.run([exe, src, dst], capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"h264_lavc_decode failed: "
                               f"{r.stderr[-300:]}")
        count, w, h = (int(x) for x in r.stdout.split())
        raw = np.fromfile(dst, np.uint8)
    fsz = w * h * 3 // 2
    pics = []
    for i in range(count):
        fr = raw[i * fsz:(i + 1) * fsz]
        pics.append((fr[:w * h].reshape(h, w),
                     fr[w * h:w * h + w * h // 4].reshape(h // 2, w // 2),
                     fr[w * h + w * h // 4:].reshape(h // 2, w // 2)))
    return pics


def normalize_startcodes(data: bytes) -> bytes:
    """`data` with every 3-byte start code rewritten to 4 bytes."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        if (i + 3 <= n and data[i] == 0 and data[i + 1] == 0
                and data[i + 2] == 1 and (i == 0 or data[i - 1] != 0)):
            out += b"\x00\x00\x00\x01"
            i += 3
        else:
            out.append(data[i])
            i += 1
    return bytes(out)

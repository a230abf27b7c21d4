"""Streams for tests, chip_smoke.py and ops/wave_phases.py."""

from __future__ import annotations

from ..models.h264.nalu import split_annexb

# the 1080p workload: make_stream(**STREAM_1080P) from testing.h264enc, a
# High-profile CAVLC stream of two IDR pictures (I16x16/I4x4/I8x8 and
# I_PCM macroblocks), repeated to a batch of 16 by repeat_pictures
STREAM_1080P = dict(width_mbs=120, height_mbs=68, n_pictures=2, seed=2026,
                    profile=100, transform_8x8=True, allow_pcm=True,
                    mb_kinds=("i16", "i4", "i8"))


def repeat_pictures(data: bytes, reps: int) -> bytes:
    """Annex-B stream with its IDR access units repeated `reps` times
    (one slice per picture): parameter sets, pictures, trailing NALUs."""
    units = [raw for _, raw in split_annexb(data)]
    idr = [i for i, u in enumerate(units) if u[0] & 0x1F == 5]
    head, pics, tail = (units[:idr[0]], units[idr[0]:idr[-1] + 1],
                        units[idr[-1] + 1:])
    sc = b"\x00\x00\x00\x01"
    return b"".join(sc + u for u in head + pics * reps + tail)

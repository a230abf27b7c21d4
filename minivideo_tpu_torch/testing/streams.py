"""Streams for tests, chip_smoke.py and ops/wave_phases.py."""

from __future__ import annotations

import hashlib
import os

from ..models.h264.nalu import split_annexb

# the 1080p workload: make_stream(**STREAM_1080P) from testing.h264enc, a
# High-profile CAVLC stream of two IDR pictures (I16x16/I4x4/I8x8 and
# I_PCM macroblocks), repeated to a batch of 16 by repeat_pictures
STREAM_1080P = dict(width_mbs=120, height_mbs=68, n_pictures=2, seed=2026,
                    profile=100, transform_8x8=True, allow_pcm=True,
                    mb_kinds=("i16", "i4", "i8"))

# the 1080p CABAC workload: make_stream2(**STREAM_1080P_CABAC) from
# testing.h264enc2, two IDR pictures with CABAC, 8x8 transforms and I_PCM
STREAM_1080P_CABAC = dict(width_mbs=120, height_mbs=68, n_pictures=2,
                          seed=2026, entropy="cabac",
                          mb_kinds=("i16", "i4", "i8"), transform_8x8=True,
                          allow_pcm=True)


def repeat_pictures(data: bytes, reps: int) -> bytes:
    """Annex-B stream with its IDR access units repeated `reps` times
    (one slice per picture): parameter sets, pictures, trailing NALUs."""
    units = [raw for _, raw in split_annexb(data)]
    idr = [i for i, u in enumerate(units) if u[0] & 0x1F == 5]
    head, pics, tail = (units[:idr[0]], units[idr[0]:idr[-1] + 1],
                        units[idr[-1] + 1:])
    sc = b"\x00\x00\x00\x01"
    return b"".join(sc + u for u in head + pics * reps + tail)


def _join(units) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def cut_idr(data: bytes, picks, keep: float) -> bytes:
    """`data` with the IDR NALUs numbered in `picks` (0 = the first IDR
    NALU) cut to `keep` of their length: slices whose parse fails."""
    units = [raw for _, raw in split_annexb(data)]
    idr = [i for i, u in enumerate(units) if u[0] & 0x1F == 5]
    for k in picks:
        u = units[idr[k]]
        units[idr[k]] = u[:max(2, int(len(u) * keep))]
    return _join(units)


# streams with bad IDR pictures, which the decoder drops as the reference
# does (models/h264/decoder.py): name -> (make_stream kwargs, how to spoil)
#   truncated_idr - the second of three IDR pictures cut to a third;
#   joined_id0    - two streams end to end, both with SPS/PPS id 0, so the
#                   second's parameter sets also govern the first's pictures;
#   error_run     - 66 pictures cut to a third after 2 good ones: one cut
#                   picture still parses (its last MBs stay unparsed), the
#                   others fail, and the decode stops once the error count
#                   passes 64, before the 4 good pictures at the end.
BAD_STREAMS = {
    "truncated_idr": (dict(width_mbs=4, height_mbs=3, n_pictures=3, seed=5),
                      dict(picks=(1,), keep=1 / 3)),
    "joined_id0": (dict(width_mbs=4, height_mbs=3, n_pictures=3, seed=5),
                   dict(width_mbs=6, height_mbs=2, n_pictures=2, seed=6)),
    "error_run": (dict(width_mbs=2, height_mbs=2, n_pictures=72, seed=7),
                  dict(picks=range(2, 68), keep=1 / 3)),
}


def bad_stream(name: str, make_stream) -> bytes:
    """The stream BAD_STREAMS[name], encoded with `make_stream`
    (testing.h264enc's, or the fixture encoder, which gives the same
    bytes)."""
    kw, spoil = BAD_STREAMS[name]
    if name == "joined_id0":
        return make_stream(**kw) + make_stream(**spoil)
    return cut_idr(make_stream(**kw), **spoil)


# a real encoder's stream, for hosts without libavcodec (chip_smoke.py):
# libx264 through tools/x264_fixture.c, 128x96, 2 IDR pictures, QP 24,
# CABAC, 8x8 transform, seed 37, 4 slices per picture (the arguments of
# tests/test_golden_x264.py::test_x264_multislice_cabac_8x8), with the
# SHA-256 of the stream and of libavcodec's (Y, Cb, Cr) of each picture
# (tools/h264_lavc_decode.c)
X264_STREAM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "x264_128x96_cabac8x8_s4.264")
X264_SHA256 = ("e77420ec2dc918d3b0dc73becb411e01"
               "854055eb642e90abfe84681216f20a2a")
X264_LAVC_DIGESTS = [
    ["c8cc7918f906e9be446623c47d5b47854df8ab841d88db5aa492b9a8bad1ac23",
     "7a3cae62a0f31bd779d019462b2d659217a74ca76061e481e42a7af11c97a179",
     "e9cc9902f50d7c53a18f196c90a70950f23d276a9492164ade7cb8c6017ed028"],
    ["14ba39f098682397f2effc02e0a0e65c3909050a2bec49bb8763aed47adb878c",
     "bee13ccf809839ccd4d36c4f4b795bef76de535113b0b3dde593894951b75131",
     "24b9417c11619940ca69ec447aebf9a42018c6b633eae1dfb0958d7c27a94541"],
]

# a real encoder's 1080p pictures, for hosts without libavcodec
# (chip_smoke.py): one dense picture each (default noise mask, QP 26),
# 1920x1080 with SPS cropping, from testing/x264.x264_stream(1920, 1080,
# 1, 26, cabac, dct8, seed, slices) (the arguments of
# tests/test_torch_x264.py's 1080p cases), with the SHA-256 of the stream
# and of libavcodec's display-cropped (Y, Cb, Cr) (testing/x264.
# lavc_decode): name -> (file, x264_stream's arguments after the
# picture count and QP (cabac, dct8, seed, slices), stream SHA-256,
# digests)
X264_1080P = {
    "cavlc": (
        "x264_1080p_cavlc_s42.264", (0, 0, 42, 1),
        "806b9020301b8a78df47d774ac611775a897b9b439ea3af1089c93065a3dccfe",
        ["52a02496202c3bf80148edb1acc0b3394b221a37e5b8a1d68332b0b07602512a",
         "2fac6765e44b59dbc00d44044a9a4d10858958523327c0b1663bd0512b81f87d",
         "5c2cd42be1ea4c64e85e38feadf36735a6b5ad6fad1951e7062a086fda7380e4"]),
    "cabac_8x8": (
        "x264_1080p_cabac8x8_s43.264", (1, 1, 43, 1),
        "75aa698372171bc050cba75eba0fce8e32ccc5564fb9ce97575de86db0b0bf77",
        ["7438859c797f543e2c0e1cf37cadf0ac47af4eebcc4cb66e2f50060288633c40",
         "8f0c7e7ade4b31317d44576227aafe63a0d67998f0b02534355dd92d811ff5d9",
         "6ba00fbb2f08eb49e3aa3b4a117460ebb5877bb8c5006f5700a972ad0afa5221"]),
    "cabac_8x8_4slices": (
        "x264_1080p_cabac8x8_4slices_s44.264", (1, 1, 44, 4),
        "6389328767ef9cb35b7b1bbb3b95f9dbe994ce214c07e27e9b925b3e85fe9e5c",
        ["c0eb408a717acdfbdf7165365f700611458200f8b1287259bed608fe847af926",
         "54b5df08b4e343756ef09666369a2480d22ae8249965b908fc2a5d4dcc61b8f8",
         "548c0e7b9e9304398c95a3e0d86d640b219b290e5212511ed02bfcd66dcf1548"]),
}


def x264_1080p(name: str) -> bytes:
    """The committed stream X264_1080P[name]; raises where the file is
    missing or its SHA-256 is not the pinned one."""
    fname, _, sha, _ = X264_1080P[name]
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           fname), "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha:
        raise RuntimeError(f"{fname}: SHA-256 is not the pinned one")
    return data

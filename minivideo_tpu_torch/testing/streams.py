"""Streams for tests, chip_smoke.py and ops/wave_phases.py."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..models.h264.nalu import split_annexb

HERE = os.path.dirname(os.path.abspath(__file__))

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
X264_STREAM = os.path.join(HERE, "x264_128x96_cabac8x8_s4.264")
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


def read_pinned(fname: str, sha: str) -> bytes:
    """The committed file `fname` of this directory; raises where it is
    missing or its SHA-256 is not `sha`."""
    path = os.path.join(HERE, fname)
    if not os.path.exists(path):
        raise RuntimeError(f"{path} is missing")
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha:
        raise RuntimeError(f"{fname}: SHA-256 is not the pinned one")
    return data


def x264_1080p(name: str) -> bytes:
    """The committed stream X264_1080P[name]; raises where the file is
    missing or its SHA-256 is not the pinned one."""
    fname, _, sha, _ = X264_1080P[name]
    return read_pinned(fname, sha)


def picture_sha256(y, cb, cr) -> str:
    """One SHA-256 over a picture's Y, Cb and Cr planes, in that order."""
    h = hashlib.sha256()
    for plane in (y, cb, cr):
        h.update(np.ascontiguousarray(plane).tobytes())
    return h.hexdigest()


# bench.py's own workload (its get_stream at the repo root): five libx264
# streams of 8 distinct IDR pictures at 1920x1088 (no cropping), QP 26,
# seed 42, noise mask 7 - CAVLC, CABAC, both with the 8x8 transform, and
# CABAC in 4 slices a picture - made by testing/x264.x264_stream(*args)
# with libx264 0.164.3095 (through libavcodec 59.37.100, FFmpeg 5.1),
# with the SHA-256 of the stream and picture_sha256 of each of
# libavcodec's 8 pictures (testing/x264.lavc_decode, the same
# libavcodec): name -> (file, x264_stream's arguments, stream SHA-256,
# digests).  To make them again: write x264_stream(*args) to the file and
# pin the new SHA-256 and lavc_decode's digests here.
BENCH_X264 = {
    "cavlc": (
        "bench_x264_1080p_cavlc.264", (1920, 1088, 8, 26, 0, 0, 42, 1, 7),
        "d6a3de7bac945a577c95126b85f3a42c0414d60350c49861d3aaf09de84d5862",
        ["9cc4b29615a2827b7bfc2ec2c18ac4eae1b301ff0a2380cfb66cdbde7ca1bf05",
         "b0187b1572f3bf9bb7ad976f5873814af447f0cfab3e1226c7f09e6b7b0dd77d",
         "afef1ade3818cf74e7159748031b1b22603daf8c46f331cedc42d8597fb4c632",
         "036fb1d6617dd37bf339040e681ae30ba3ff61bc9f29a0ba69e7ce6208317cc9",
         "448a03e3485e4feef4ddf94b6642565410d863d07ba9dbb9e3f4bedcd8d44430",
         "cd7b9b1d96c59c8a8974f65eece1ce4c6fe31fece8799b33b5a4641e913f9cc9",
         "ea7c353671bf905c417a78452bdcad93beb0650e5023b2c629927f974109dff4",
         "3ca578d11c8a960955085527d7795d0ddc220c3b4a110010665097a59492cf53"]),
    "cabac": (
        "bench_x264_1080p_cabac.264", (1920, 1088, 8, 26, 1, 0, 42, 1, 7),
        "59ee5cf11cd90022a564c2af80927329c158c7f2bc919e6712eff594dcf86380",
        ["17ef560823bbf75464677e3cd4d35720e3ec15d1475f7ee46ae7456aa281352d",
         "3e3e1b6339bf4a38d39bb8aa16b8204b6dab745efefd13681d914e7de72dc754",
         "0228ced8a01b364898297ac32aaf52b7e0114e596fa60a5e7808ee3d4e3ed7db",
         "bdaf130397ac3e1dada28b8e4d1aa3ae18d0f0e3562cb8aab591d73787a27cde",
         "5db159551bf192e621048d324232d740b2d595e59584cf0de6104c7257c3a6aa",
         "07d2449e7ddd317de8084cdd66f2b2b61bd09affd26604b0b438fb28f0b4e678",
         "14163591c403fc2223abdaec788b9eb30e4300985e0cb4cfb3ac34a1027b319d",
         "c510ddf200eb65d51891bb8e66a1c7e7939891948f6aaaaa0ae8cd02cb98fdb0"]),
    "cavlc_8x8": (
        "bench_x264_1080p_cavlc_8x8.264", (1920, 1088, 8, 26, 0, 1, 42, 1, 7),
        "4fa441e4c76ca1e6da9ce819b23000d5f57f0aa79356c3b1a750a5adb49ff5df",
        ["8c8660e34f11f96590483743c8ae8c8bdc328a5130440a372a9d86efb1a37f48",
         "c675b4c2c11d6e76112c5cbb2dfd0e58b64ca9516df5c985c6c0cc32fe34593e",
         "bff7e4f9f7817a29d7138d14dfaa754e4d5b04759d163859b4be18ce29eaa445",
         "b1b19ccec0aef2300ccab06a7e4e939eb698cf56cdc3a30837effdbbd2e67419",
         "f4605b3ada9b6a89b62a56c5e39b06bef4a2329d843c8708d52d8e5b616b5453",
         "2de2cc418f794d4207d88a64a69340419b973ef6d249692a7c56cf61d2ba35e3",
         "3d9dd36cda7de2905190e781d1a3a464d98283492a666675944dc19604308bd2",
         "006273556e1f3b8e21e351520da35c3134e72002d2f7f7d05efc72e3409fa502"]),
    "cabac_8x8": (
        "bench_x264_1080p_cabac_8x8.264", (1920, 1088, 8, 26, 1, 1, 42, 1, 7),
        "dc8526eef1bb891802037880686ccb9547b0835203d52ca153c47f62a5bc7668",
        ["f84f8a628d751eab6524d180f52feaef7515f5ab2f4c475e4a627a2c3980b57f",
         "9a1f41142d04abc6f1f251ee1b45ff366c62c81f18258a57f2c7f2c06c82e0c7",
         "9aaef52f7fb8313472f1b9e026fb30ee13a3f9eb94c3aa7d37069b53675bb3f2",
         "fb6f6057553c7cfa9c05b7fb53019fcc987e171bd6b385abd83da0d4e4f17dfb",
         "8bf5d0690f13a0900d5211862e16b731ccbb3e165182c97def69d1686a6ff151",
         "2e56789b865d7309901431a93a85a41890ebf3b8cc8c8a61439403420e2a8db7",
         "7e2c7009838de1f81148ea87b28ea5626a3037385a3db9a90d50f366f65464ff",
         "cbd7effce1280122e3840949be16f69e378e0c5e0b4cb20c72bd56c7ddb9f746"]),
    "cabac_s4": (
        "bench_x264_1080p_cabac_s4.264", (1920, 1088, 8, 26, 1, 0, 42, 4, 7),
        "752c81bf28b55f5c34c50169f56d9a50c6891229c134158f2dd5904bac3390e0",
        ["fdf0519eedc2db6adfed325ed2c604358de89fc3a10e3a5645270565568d9258",
         "ecf1b28de0d8a1315529da0d6a25e08dcd3fe3493c4a2368a37711c1dc432028",
         "002b85cb227f9069097abbc2c77a4b6066edfa5e6696250f6164e74ce38473cc",
         "36b6838d0ba0ce21aba2cbb8c062e54f71b6301917ba619a4426e5605e232284",
         "052b9325fe45c54de7a23e8d4be3c35e6cea390f46619f24c040cf44681ca5c4",
         "a495518654fdd15ea0f77008d5d080127349b58aa71bad380ca846fa8c9c7150",
         "8ccbd73c7227611fb1ef215820a7da3d287bc36665117186c37d5e836ed7ea7c",
         "ebea19a926d968c2c4093d1aa1785c462fc71224e1723fae48afea7c65257786"]),
}


def bench_x264(name: str) -> bytes:
    """The committed stream BENCH_X264[name]; raises where the file is
    missing or its SHA-256 is not the pinned one."""
    fname, _, sha, _ = BENCH_X264[name]
    return read_pinned(fname, sha)

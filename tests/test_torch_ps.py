"""MPEG-PS H.264 samples are access units in both of the port's demuxers
(containers/mpeg_ps.py and native/src/demux.cc), on the CPU.

The JAX package makes each PES packet a sample, so an access unit split
over packets reaches its decoder cut to the first packet (ROADMAP §C,
"Differences by design").  The port reads the payloads of one stream as
one Annex-B stream and splits it at access unit boundaries: here on
write_ps's fixed-size packets (188 and 2,048 bytes, as DVD muxers pack),
its 65,535-byte split of a picture larger than a packet, crafted files
(a start code cut between two packets, a packet holding the tail of one
access unit and the head of the next, an IDR slice behind 5,000 bytes of
SEI) and libavformat's own "vob" muxer where it builds.  Each time the
Python and native tables agree entry for entry, mv_decode(device="cpu")
gives the pictures of the Annex-B stream, and the extractor's ES and
batch_thumbnail carry the same pictures.  Where every packet holds one
whole access unit, the tables are the JAX package's.  torch and the port
are imported inside the tests (see torch_port_helpers.py).
"""

import os

import numpy as np
import pytest

from test_torch_demux import _assert_same_media, _demux

# small streams: name -> keyword arguments of the port's encoders
STREAMS = {
    "cavlc": dict(width_mbs=4, height_mbs=3, n_pictures=3, seed=77),
    "slices": dict(width_mbs=5, height_mbs=4, n_pictures=2, seed=78,
                   n_slices=3),
    "cabac": dict(width_mbs=5, height_mbs=3, n_pictures=3, seed=52,
                  entropy="cabac", transform_8x8=True),
    # 16x12 I_PCM macroblocks: 73.7 KB a picture, over one PES packet
    "pcm": dict(width_mbs=16, height_mbs=12, n_pictures=2, seed=79,
                mb_kinds=("pcm",)),
}
# the NAL unit types that write_ps carries (SPS, PPS, IDR slices)
CARRIED = (5, 7, 8)


def _stream(name):
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    kw = STREAMS[name]
    return make_stream2(**kw) if "entropy" in kw else make_stream(**kw)


def _nals(data, types=None):
    from minivideo_tpu_torch.models.h264.nalu import split_annexb
    return [n for _, n in split_annexb(data)
            if types is None or n[0] & 0x1F in types]


def _units(data):
    """write_ps's access units of `data`: Annex-B bytes each, the first
    with the parameter sets."""
    from minivideo_tpu_torch.containers.mp4 import avcc_to_annexb
    from minivideo_tpu_torch.testing.containers import annexb_to_avcc_samples
    sps, pps, samples = annexb_to_avcc_samples(data)
    units = [avcc_to_annexb(s) for s in samples]
    units[0] = b"".join(b"\x00\x00\x00\x01" + x for x in sps + pps) \
        + units[0]
    return units


def _ps(packets):
    """A program stream of PES packets [(payload, pts or None)]."""
    from minivideo_tpu_torch.testing.containers import pes_packet
    pack = (b"\x00\x00\x01\xba" + bytes([0x44, 0, 4, 0, 4, 1, 1, 0x89,
                                          0xc3, 0xf8]))
    return pack + b"".join(pes_packet(p, t) for p, t in packets) \
        + b"\x00\x00\x01\xb9"


def _write(tmp_path, data, name="clip.mpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _port_tables(path):
    """The port's Python and native demux of `path`, which must agree
    (every field, the fragment lists included): the Python MediaFile."""
    from minivideo_tpu_torch import api
    ok_py, py = _demux(api, path, False)
    ok_nat, nat = _demux(api, path, True)
    assert ok_py and ok_nat
    _assert_same_media(py, nat)
    return py


def _samples(media):
    from minivideo_tpu_torch.api import mv_close, mv_open
    t = media.tracks_video[0]
    m = mv_open(media.file_path)
    try:
        return [t.read_sample(m.file_handle, i)
                for i in range(t.sample_count)]
    finally:
        mv_close(m)


def _assert_decodes_as(path, stream, tmp_path):
    """mv_decode(device="cpu") of `path` gives decode_annexb's pictures
    of `stream`, and so does the extractor's ES, whose NAL units are the
    file's."""
    from minivideo_tpu_torch.api import (mv_close, mv_decode, mv_extract,
                                         mv_open, mv_parse)
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    want = decode_annexb(stream, device="cpu")
    m = mv_open(path)
    try:
        assert mv_parse(m)
        got = mv_decode(m, picture_number=64, device="cpu")
        es = mv_extract(m, m.tracks_video[0], str(tmp_path))
    finally:
        mv_close(m)
    with open(es, "rb") as f:
        es = f.read()
    assert len(got) == len(want) > 0
    for pics in (got, decode_annexb(es, device="cpu")):
        assert len(pics) == len(want)
        for a, b in zip(pics, want):
            for pa, pb in zip((a.y, a.cb, a.cr), (b.y, b.cb, b.cr)):
                np.testing.assert_array_equal(pa, pb)
    return es


@pytest.mark.parametrize("name,packet_size", [
    ("cavlc", 188), ("slices", 2048), ("cabac", 188), ("pcm", None),
    ("pcm", 2048)])
def test_write_ps_packings(name, packet_size, tmp_path):
    """write_ps(s, packet_size): one sample per picture, each an IDR
    access unit whose bytes are the picture's, with the PTS of the
    packet holding its first byte; the pictures and the extracted ES
    are the stream's.  "pcm" without packet_size splits each picture
    over two 65,535-byte packets."""
    from minivideo_tpu_torch.codecs import SampleType
    from minivideo_tpu_torch.testing.containers import write_ps
    stream = _stream(name)
    data = write_ps(stream, packet_size=packet_size)
    media = _port_tables(_write(tmp_path, data))
    t = media.tracks_video[0]
    units = _units(stream)
    es = b"".join(units)
    room = (packet_size or 0) - 14
    first = np.cumsum([0] + [len(u) for u in units[:-1]])
    # a unit's 4-byte start code whose zero byte ends a packet: that
    # byte stays with the unit before
    cut = [p + 1 if room and p and (p + 1) % room == 0 else p
           for p in first] + [len(es)]
    assert _samples(media) == [es[a:b] for a, b in zip(cut, cut[1:])]
    assert list(t.sample_type) == [int(SampleType.VIDEO_SYNC)] * len(units)
    assert t.fragments is not None and max(map(len, t.fragments)) > 1
    # the PTS of the packet whose payload holds each sample's first byte
    # (none, -1, where only a unit's zero byte starts in a packet)
    if packet_size is None:
        want_pts = list(np.arange(len(units)) * 3600)
    else:
        # a packet's PTS is that of the first unit starting in it
        pkt_pts = {}
        for p, k in zip(first, np.arange(len(units)) * 3600):
            pkt_pts.setdefault(p // room, k)
        want_pts = [pkt_pts.get(p // room, -1) for p in cut[:-1]]
    assert list(t.sample_pts) == [p * 100000 // 9 if p >= 0 else -1
                                  for p in want_pts]
    es = _assert_decodes_as(media.file_path, stream, tmp_path)
    assert _nals(es) == _nals(stream, CARRIED)


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_start_code_cut_between_packets(cut, tmp_path):
    """The second access unit's 4-byte start code is cut after `cut`
    bytes: 00 | 00 00 01, 00 00 | 00 01, 00 00 00 | 01.  The search runs
    over the concatenated payloads, so the unit is found in each case; it
    begins at its zero byte where that lies in the packet of its start
    code, else at the start code."""
    stream = _stream("cavlc")
    units = _units(stream)[:2]
    es = units[0] + units[1]
    b = len(units[0]) + cut
    media = _port_tables(_write(tmp_path, _ps([(es[:b], 0),
                                               (es[b:], 3600)])))
    got = _samples(media)
    # the PTS of the packet that holds the unit's first byte
    if cut == 1:
        assert got == [units[0] + b"\x00", units[1][1:]]
        want_pts = [0, 3600 * 100000 // 9]
    else:
        assert got == units
        want_pts = [0, 0]
    assert media.tracks_video[0].sample_pts.tolist() == want_pts
    _assert_decodes_as(media.file_path, es, tmp_path)


def _sei(size):
    """An SEI NAL unit (user data unregistered) of about `size` bytes
    with no 00 00 in it."""
    body = bytes([5]) + b"\xff" * (size // 255) + bytes([size % 255])
    return b"\x00\x00\x00\x01\x06" + body + b"\x41" * size + b"\x80"


def test_packet_holds_a_tail_and_a_head(tmp_path):
    """Three packets: the head of the first access unit; its tail and the
    head of the second, which opens with an access unit delimiter and
    5,000 bytes of SEI before its IDR slice (past the 4,096 bytes that
    the JAX package searches for an IDR); the rest.  Two samples, both
    VIDEO_SYNC, the second with the PTS of the packet where it starts."""
    from minivideo_tpu_torch.codecs import SampleType
    stream = _stream("cavlc")
    u0, u1 = _units(stream)[:2]
    u1 = b"\x00\x00\x00\x01\x09\xf0" + _sei(5000) + u1
    es = u0 + u1
    a, b = len(u0) // 2, len(u0) + 3000
    media = _port_tables(_write(tmp_path, _ps(
        [(es[:a], 0), (es[a:b], 3600), (es[b:], None)])))
    t = media.tracks_video[0]
    assert _samples(media) == [u0, u1]
    assert t.fragments == [[(t.sample_offset[0], a),
                            (t.fragments[0][1][0], len(u0) - a)],
                           [(t.sample_offset[1], b - len(u0)),
                            (t.fragments[1][1][0], len(es) - b)]]
    assert list(t.sample_type) == [int(SampleType.VIDEO_SYNC)] * 2
    assert t.sample_pts.tolist() == [0, 3600 * 100000 // 9]
    _assert_decodes_as(media.file_path, es, tmp_path)


@pytest.mark.parametrize("name", ["cavlc", "slices", "cabac"])
def test_aligned_tables_are_the_jax_package_s(name, tmp_path):
    """Where every PES packet holds one whole access unit (the fixture
    writer's files), both of the port's demuxers give the JAX package's
    tables: same samples, offsets, sizes, types, timestamps, no
    fragments."""
    from fixtures import containers as FC
    from minivideo_tpu import api as jax_api
    stream = _stream(name)
    data = FC.write_ps(stream)
    from minivideo_tpu_torch.testing.containers import write_ps
    assert write_ps(stream) == data
    path = _write(tmp_path, data)
    got = _port_tables(path)
    assert got.tracks_video[0].fragments is None
    for native in (False, True):
        ok, want = _demux(jax_api, path, native)
        assert ok
        _assert_same_media(want, got)


def test_mpeg2_program_streams_keep_a_sample_per_packet(tmp_path):
    """MPEG-2 video and MP2/AC-3/DTS audio keep one sample per PES
    packet: the JAX package's tables, from both demuxers."""
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch.testing.containers import write_ps_mpeg2
    for audio in ("mp2", "ac3", "dts"):
        path = _write(tmp_path, write_ps_mpeg2(audio=audio, n_packets=5),
                      f"{audio}.mpg")
        got = _port_tables(path)
        assert [t.sample_count for t in got.tracks] == [5, 1]
        ok, want = _demux(jax_api, path, True)
        assert ok
        _assert_same_media(want, got)


def test_batch_thumbnail_reads_split_access_units(tmp_path):
    """batch_thumbnail(device="cpu") demuxes a 2,048-byte-packed PS
    file into whole pictures: its YUV420 thumbnails are the stream's
    pictures."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.parallel import batch_thumbnail
    from minivideo_tpu_torch.testing.containers import write_ps
    stream = _stream("pcm")
    path = _write(tmp_path, write_ps(stream, packet_size=2048))
    out = tmp_path / "thumbs"
    res = batch_thumbnail([path], str(out), pictures_per_clip=2,
                          fmt=PictureFormat.YUV420, device="cpu")
    assert not res.failed
    want = decode_annexb(stream, device="cpu")
    files = sorted(f for f in os.listdir(out) if f.endswith(".yuv"))
    assert len(files) == len(want) == 2
    for name, p in zip(files, want):
        raw = np.fromfile(out / name, np.uint8)
        np.testing.assert_array_equal(
            raw, np.concatenate([p.y.ravel(), p.cb.ravel(), p.cr.ravel()]))


def test_libavformat_vob_file(tmp_path):
    """A libx264 stream muxed by libavformat's "vob" muxer (2,048-byte
    packs, tools/lavf_ps_mux.c): its pictures are libavcodec's, and the
    extracted ES holds the stream's NAL units.  Skips where the tools do
    not build (no libavformat)."""
    from minivideo_tpu_torch.api import (mv_close, mv_decode, mv_extract,
                                         mv_open, mv_parse)
    from minivideo_tpu_torch.testing import x264
    try:
        x264.encoder(), x264.decoder(), x264.ps_muxer()
    except RuntimeError as e:
        pytest.skip(f"libx264/libavcodec/libavformat tools unavailable: "
                    f"{e}")
    stream = x264.x264_stream(96, 64, 3, 26, 1, 1, 5, slices=2)
    path = _write(tmp_path, x264.lavf_ps(stream))
    media = _port_tables(path)
    assert media.tracks_video[0].sample_count == 3
    want = x264.lavc_decode(stream)
    m = mv_open(path)
    try:
        assert mv_parse(m)
        got = mv_decode(m, picture_number=8, device="cpu")
        es = mv_extract(m, m.tracks_video[0], str(tmp_path))
    finally:
        mv_close(m)
    assert len(got) == len(want) == 3
    for p, ref in zip(got, want):
        for a, b in zip(p.cropped(), ref):
            np.testing.assert_array_equal(a, b)
    with open(es, "rb") as f:
        assert _nals(f.read()) == _nals(stream)

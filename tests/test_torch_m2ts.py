"""BDAV transport streams (Blu-ray .m2ts, AVCHD .mts) in the port, on the
CPU: 192-byte source packets, each a 4-byte TP_extra_header before a TS
packet.  The committed 128x96 libx264 stream of 2 pictures in 4 slices
is written by testing/containers.write_m2ts with arrival time stamps
whose second byte is 0x47 in every header (a demuxer that resyncs on any
0x47 parses a bogus packet there and loses a real one) and a null packet
every 5 packets.  Both demuxers (native/src/demux.cc and
containers/ts.py) must give, access unit by access unit, what a plain
source-packet reader of this file gives, and the same from the file's
188-byte form; probe finds the format by content; the walk's span
counts its packets, null packets and resyncs; batch_thumbnail's
thumbnails of such files hold the plain reference decoder's planes
(tvbench/reference/decode.py) and pass its JPEG check.  torch and the
port are imported inside the tests (see torch_port_helpers.py).
"""

import os

import numpy as np
import pytest

# every header's second byte 0x47: 432 ticks a packet at 96 Mb/s keep the
# stamp's upper bytes over a file of this size
WRITE = dict(mux_rate=96_000_000, ats_start=0x470000, null_every=5)
VIDEO_PID = 0x1011


def _stream(order=(0, 1)):
    """The committed 4-slice stream with its pictures in `order`."""
    from minivideo_tpu_torch.testing.containers import access_units
    from minivideo_tpu_torch.testing.streams import X264_STREAM
    with open(X264_STREAM, "rb") as f:
        units = access_units(f.read())
    return b"".join(units[k] for k in order)


def _m2ts(order=(0, 1)):
    from minivideo_tpu_torch.testing.containers import write_m2ts
    return write_m2ts(_stream(order), **WRITE)


def _ts188(m2ts):
    return b"".join(m2ts[i + 4:i + 192] for i in range(0, len(m2ts), 192))


def plain_units(m2ts):
    """The access units of PID 0x1011 in a BDAV file: 0x47 at +4 of every
    192-byte source packet, the header stripped, the payloads gathered
    into PES units by payload_unit_start_indicator, the PES headers
    stripped."""
    pk = np.frombuffer(m2ts, np.uint8).reshape(-1, 192)
    assert (pk[:, 4] == 0x47).all()
    units = []
    for p in pk[:, 4:]:
        pid = (int(p[1]) & 0x1F) << 8 | int(p[2])
        if pid != VIDEO_PID or not p[3] & 0x10:
            continue
        start = 4 + (1 + int(p[4]) if p[3] & 0x20 else 0)
        if p[1] & 0x40:
            units.append(bytearray())
        units[-1] += p[start:].tobytes()
    out = []
    for u in units:
        assert u[:3] == b"\x00\x00\x01"
        out.append(bytes(u[9 + u[8]:]))
    return out


def _write(tmp_path, data, name):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _samples(path, native, monkeypatch):
    """(samples read through track.read_sample, their types, container)
    of the video track, demuxed natively or by the Python demuxer."""
    from minivideo_tpu_torch.api import mv_close, mv_open, mv_parse
    monkeypatch.setenv("MINIVIDEO_TPU_NO_NATIVE", "0" if native else "1")
    m = mv_open(path)
    try:
        assert mv_parse(m)
        t = m.tracks_video[0]
        return ([t.read_sample(m.file_handle, i)
                 for i in range(t.sample_count)],
                [int(k) for k in t.sample_type], m.container)
    finally:
        mv_close(m)


def _session(fn):
    from torch.profiler import ProfilerActivity, profile
    from minivideo_tpu_torch import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.last_session()


def test_writer_puts_0x47_in_headers_and_null_packets():
    data = _m2ts()
    pk = np.frombuffer(data, np.uint8).reshape(-1, 192)
    assert len(pk) % 32 == 0
    assert (pk[:, 1] == 0x47).all()
    assert ((pk[:, 5] & 0x1F) == 0x1F).sum() >= len(pk) // 6
    ats = pk[:, :4].astype(np.int64) @ [1 << 24, 1 << 16, 1 << 8, 1]
    assert (np.diff(ats) == 432).all()


@pytest.mark.parametrize("form", ["192", "188"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_samples_are_the_plain_reader_s(form, native, tmp_path,
                                        monkeypatch):
    from minivideo_tpu_torch.codecs import Container, SampleType
    from minivideo_tpu_torch.testing.containers import access_units
    data = _m2ts((1, 0))
    want = plain_units(data)
    assert want == access_units(_stream((1, 0)))
    path = _write(tmp_path, data if form == "192" else _ts188(data),
                  f"clip.{'m2ts' if form == '192' else 'ts'}")
    got, kinds, container = _samples(path, native, monkeypatch)
    assert container == Container.MPEG_TS
    assert got == want
    assert kinds == [int(SampleType.VIDEO_SYNC)] * 2


def test_probe_finds_bdav_by_content(tmp_path, monkeypatch):
    """Under a name that says nothing, by the sync bytes at 4, 196, 388."""
    from minivideo_tpu_torch import probe
    from minivideo_tpu_torch.codecs import Container
    data = _m2ts()
    assert probe.detect_container_from_bytes(data[:392]) == \
        Container.MPEG_TS
    assert probe.detect_container_from_bytes(
        data[:4] + b"\x00" + data[5:392]) == Container.UNKNOWN
    path = _write(tmp_path, data, "clip.bin")
    for native in (True, False):
        got, _, container = _samples(path, native, monkeypatch)
        assert container == Container.MPEG_TS
        assert got == plain_units(data)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_the_walk_counts_packets_nulls_and_resyncs(native, tmp_path,
                                                   monkeypatch):
    """One demux.ts span a file: items the packets, bytes the file's,
    packet size 192 (188 for the file's 188-byte form), no resync; 100
    bytes lost inside the second picture's packets cost one resync, the
    first picture is whole, and the walk goes on at 192."""
    data = _m2ts()
    pid = [(data[i + 5] & 0x1F) << 8 | data[i + 6]
           for i in range(0, len(data), 192)]
    n, null = len(pid), pid.count(0x1FFF)
    # a cut inside the second picture's packets leaves packet k walked
    # (its sync stands) and k + 1's sync behind the stride: that packet
    # is lost
    k = max(i for i, p in enumerate(pid) if p == VIDEO_PID) - 6
    cut = 192 * k + 50
    files = {"clip.m2ts": (data, 192, 0, n, null),
             "clip.ts": (_ts188(data), 188, 0, n, null),
             "cut.m2ts": (data[:cut] + data[cut + 100:], 192, 1, n - 1,
                          null - (pid[k + 1] == 0x1FFF))}
    for name, (blob, size, resyncs, packets, nulls) in files.items():
        path = _write(tmp_path, blob, name)
        (got, _, _), recs = _session(
            lambda: _samples(path, native, monkeypatch))
        span, = [r for r in recs if r.name == "demux.ts"]
        assert span.info == {"packet_size": size, "resyncs": resyncs,
                             "nulls": nulls}, name
        assert span.nbytes == len(blob) and span.items == packets
        want = plain_units(data)
        assert got[0] == want[0]
        assert (got == want) == (not resyncs)


def test_batch_thumbnail_of_bdav_files(tmp_path, monkeypatch):
    """Three .m2ts files through batch_thumbnail(device="cpu") to JPEG,
    under a profiler session: each thumbnail's planes are the plain
    reference decoder's of the file's first picture and its file passes
    the reference's JPEG check; one demux.ts span a file (packet size
    192, no resync) and one batch.parse_slice span a slice, 4 under each
    batch.parse_picture."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.export import image
    from minivideo_tpu_torch.parallel import batch_thumbnail
    from tvbench.reference import jpg
    from tvbench.reference.decode import cropped, decode_picture
    orders = [(0, 1), (1, 0), (1, 0)]
    paths = [_write(tmp_path, _m2ts(o), f"c{i}.m2ts")
             for i, o in enumerate(orders)]
    taps, orig = {}, image.export_picture

    def tap(base, fmt, y, cb, cr, quality=75, rgb=None):
        taps[os.path.basename(base)] = [np.array(p) for p in (y, cb, cr)]
        return orig(base, fmt, y, cb, cr, quality, rgb=rgb)

    monkeypatch.setattr(image, "export_picture", tap)
    out = str(tmp_path / "out")
    res, recs = _session(lambda: batch_thumbnail(
        paths, out, device="cpu", fmt=PictureFormat.JPG, quality=75))
    assert res.done == 3 and not res.failed
    stream = _stream()
    for i, order in enumerate(orders):
        planes, size = decode_picture(stream, order[0])
        want = cropped(planes, size)
        got = taps[f"c{i}"]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        with open(os.path.join(out, f"c{i}.jpg"), "rb") as f:
            assert jpg.check_file(f.read(), want, 75)["bad_blocks"] == 0
    walks = [r for r in recs if r.name == "demux.ts"]
    assert len(walks) == 3
    assert all(r.info["packet_size"] == 192 and r.info["resyncs"] == 0
               for r in walks)
    pictures = [r for r in recs if r.name == "batch.parse_picture"]
    slices = [r for r in recs if r.name == "batch.parse_slice"]
    assert len(pictures) == 3 and len(slices) == 12
    assert sorted(sum(s.parent == p.id for s in slices)
                  for p in pictures) == [4, 4, 4]
    assert all(s.items == 1 and s.nbytes > 0 for s in slices)

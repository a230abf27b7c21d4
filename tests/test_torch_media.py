"""The port's host media layer against the JAX package's, on the CPU:
container probing, the file window of the streaming demuxers, IDR
selection, the Annex-B stream a track assembles to, the codec tables and
the trace masks.  Like test_torch_demux.py, this file imports no torch."""

import io

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream


@pytest.fixture(scope="module")
def annexb():
    return make_stream(width_mbs=4, height_mbs=3, n_pictures=3, seed=77,
                       mb_kinds=("i16", "i4"), density=0.35,
                       allow_pcm=False)


# (written as, the bytes inside, the container it holds)
MISNAMED = {
    "mp4_as_wav": ("clip.wav", lambda s: C.write_mp4(s, 64, 48), "MP4"),
    "mkv_as_mp4": ("clip.mp4", lambda s: C.write_mkv(s, 64, 48), "MKV"),
    "ts_as_avi": ("clip.avi", C.write_ts, "MPEG_TS"),
    "avi_as_ts": ("clip.ts", lambda s: C.write_avi(s, 64, 48), "AVI"),
}


@pytest.mark.parametrize("name", sorted(MISNAMED))
def test_detect_container_misnamed(name, annexb, tmp_path):
    """Magic bytes beat the extension, in both packages alike."""
    from minivideo_tpu import probe as jax_probe
    from minivideo_tpu_torch import probe
    from minivideo_tpu_torch.api import mv_close, mv_open
    fname, write, want = MISNAMED[name]
    data = write(annexb)
    path = tmp_path / fname
    path.write_bytes(data)
    m = mv_open(str(path))
    mv_close(m)
    assert m.container.name == want
    ext = fname.rsplit(".", 1)[1]
    assert probe.detect_container(io.BytesIO(data), ext) == m.container
    assert probe.detect_container_from_bytes(data[:64]) == \
        jax_probe.detect_container_from_bytes(data[:64])
    # the extension decides where the bytes cannot
    assert probe.detect_container(io.BytesIO(b"\x00" * 64), ext) == \
        jax_probe.detect_container(io.BytesIO(b"\x00" * 64), ext)


def test_filewindow_matches_bytes():
    """FileWindow serves the bytes API the streaming demuxers use; fuzzed
    against the bytes with a small window, so every access crosses
    window boundaries."""
    from minivideo_tpu_torch.bufio import FileWindow
    rng = np.random.default_rng(7)
    blob = bytes(rng.integers(0, 8, 120_000, dtype=np.uint8))
    fw = FileWindow(io.BytesIO(blob), len(blob), window=1 << 12)
    assert len(fw) == len(blob)
    for i in rng.integers(0, len(blob), 200):
        assert fw[int(i)] == blob[int(i)]
    for a, ln in zip(rng.integers(0, len(blob), 100),
                     rng.integers(0, 20_000, 100)):
        a, b = int(a), int(a + ln)
        assert fw[a:b] == blob[a:b]
    assert fw[-4:] == blob[-4:]
    for needle in (b"\x00\x00\x01", b"\x47", b"\x07\x07\x07\x07"):
        start = 0
        for _ in range(50):
            got = fw.find(needle, start)
            assert got == blob.find(needle, start)
            if got == -1:
                break
            start = got + 1


@pytest.mark.parametrize("mode", ["UNFILTERED", "ORDERED", "DISTRIBUTED"])
def test_idr_filtering_equals_jax(mode):
    """The same IDR samples picked, for every count, from a track of 80
    samples with parameter-set samples, small IDRs and non-IDR ones."""
    from minivideo_tpu.codecs import PictureRepartition as JaxRep
    from minivideo_tpu.containers.filter import idr_filtering as jax_filter
    from minivideo_tpu.media import Track as JaxTrack
    from minivideo_tpu_torch.codecs import PictureRepartition, SampleType
    from minivideo_tpu_torch.containers.filter import idr_filtering
    from minivideo_tpu_torch.media import Track
    rng = np.random.default_rng(3)
    n = 80
    types = rng.choice([int(SampleType.VIDEO_SYNC), int(SampleType.VIDEO),
                        int(SampleType.VIDEO_PARAM)], n, p=[0.7, 0.2, 0.1])
    sizes = rng.integers(100, 5000, n)
    offs = np.cumsum(sizes) - sizes
    port, jax = Track(), JaxTrack()
    port.set_samples(types, sizes, offs)
    jax.set_samples(types, sizes, offs)
    for count in (0, 1, 2, 5, 17, 200):
        got = idr_filtering(port, count, PictureRepartition[mode])
        want = jax_filter(jax, count, JaxRep[mode])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{count}")


STREAM_FILES = {
    "mp4": lambda s: C.write_mp4(s, 64, 48),
    "mkv": lambda s: C.write_mkv(s, 64, 48, lacing="xiph"),
    "ts": C.write_ts,
    "avi": lambda s: C.write_avi(s, 64, 48),
    "ps": C.write_ps,
    "264": lambda s: s,
}


@pytest.mark.parametrize("fmt", sorted(STREAM_FILES))
def test_extract_video_stream_equals_jax(fmt, annexb, tmp_path):
    """The Annex-B bytes a video track assembles to, byte for byte."""
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    path = tmp_path / f"clip.{fmt}"
    path.write_bytes(STREAM_FILES[fmt](annexb))
    got, want = api.mv_open(str(path)), jax_api.mv_open(str(path))
    assert api.mv_parse(got) and jax_api.mv_parse(want)
    data = api.extract_video_stream(got, got.tracks_video[0])
    assert data == jax_api.extract_video_stream(want, want.tracks_video[0])
    assert len(data) > 0
    api.mv_close(got)
    jax_api.mv_close(want)


def test_codec_tables_equal_jax():
    from minivideo_tpu import codecs as jax_codecs
    from minivideo_tpu_torch import codecs
    for name in ("Codec", "Container", "SampleType", "StreamType",
                 "PictureRepartition", "PictureFormat", "BitrateMode",
                 "FramerateMode", "SubSampling", "ColorMatrix"):
        want = {m.name: int(m) for m in getattr(jax_codecs, name)}
        assert {m.name: int(m) for m in getattr(codecs, name)} == want
    assert {int(k): int(v) for k, v in codecs.WAVE_FORMAT_TO_CODEC.items()} \
        == {int(k): int(v) for k, v in jax_codecs.WAVE_FORMAT_TO_CODEC
            .items()}
    for fcc in (b"avc1", b"H264", b"hvc1", b"mp4a", b"MJPG", b"xxxx",
                b"AVC1", b"DIVX"):
        key = int.from_bytes(fcc, "big")
        assert int(codecs.codec_from_fourcc(key)) == \
            int(jax_codecs.codec_from_fourcc(key))


def test_trace_masks():
    """set_module_mask / set_global_mask / enable_timestamps, as in the
    JAX package."""
    from minivideo_tpu_torch import trace
    out = io.StringIO()
    old = (dict(trace._state.masks), trace._state.stream,
           trace._state.timestamps)
    try:
        trace._state.stream = out
        trace.set_global_mask(0)
        trace.t1("DEMUX", "hidden")
        trace.set_module_mask("DEMUX", trace.ERROR | trace.LVL1)
        trace.t1("DEMUX", "shown %d", 1)
        trace.t1("MP4", "hidden")
        trace.enable_timestamps()
        trace.error("DEMUX", "late")
        lines = out.getvalue().splitlines()
        assert lines[0] == "[LVL1 ] [DEMUX] shown 1"
        assert len(lines) == 2 and lines[1].endswith("[ERROR] [DEMUX] late")
        assert lines[1].startswith("[")
        assert set(trace.MODULES) <= set(trace._state.masks)
    finally:
        trace._state.masks.update(old[0])
        trace._state.stream, trace._state.timestamps = old[1], old[2]

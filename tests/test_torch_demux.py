"""The port's demuxers against the JAX package's, on the CPU: every
container the JAX tests write, opened by both packages' mv_open and
demuxed by both packages' Python demuxers (MINIVIDEO_TPU_NO_NATIVE=1) and
by both native demuxers (native/src/demux.cc, the JAX package's library
and the port's own build of its copy).  Every Track column, every piece
of stream metadata and every MediaFile field must be equal.

This file imports no torch, and neither do the port modules it reaches
(api, media, probe, bufio, codecs, containers): see
torch_port_helpers.py for why the demux tests must not load it.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def annexb():
    return make_stream(width_mbs=4, height_mbs=3, n_pictures=3, seed=77,
                       mb_kinds=("i16", "i4"), density=0.35,
                       allow_pcm=False)


def _pcm(n=8000):
    return (np.sin(np.arange(n) / 7.0) * 8000).astype(np.int16)


# name -> (file name, writer of its bytes from the Annex-B stream)
FILES = {
    "mp4": ("clip.mp4", lambda s: C.write_mp4(s, 64, 48)),
    "mp4_visual_ext": ("ext.mp4",
                       lambda s: C.write_mp4(s, 64, 48, visual_ext=True)),
    "mkv": ("clip.mkv", lambda s: C.write_mkv(s, 64, 48)),
    "mkv_xiph": ("laced.mkv", lambda s: C.write_mkv(s, 64, 48,
                                                    lacing="xiph")),
    "mkv_info_last": ("late.mkv", lambda s: C.write_mkv(
        s, 64, 48, info_last=True, timescale=500000)),
    "ts": ("clip.ts", C.write_ts),
    "avi": ("clip.avi", lambda s: C.write_avi(s, 64, 48)),
    "avi_opendml": ("odml.avi", lambda s: C.write_avi(s, 64, 48,
                                                      opendml=True)),
    "ps": ("clip.mpg", C.write_ps),
    "ps_ac3": ("ac3.mpg", lambda s: C.write_ps_mpeg2(audio="ac3")),
    "es": ("clip.264", lambda s: s),
    "wave": ("tone.wav", lambda s: C.write_wav(_pcm())),
    "wave_extensible": ("ext.wav", lambda s: C.write_wav_extensible(
        _pcm(16000), channels=2)),
    "mp3": ("tone.mp3", lambda s: C.write_mp3(n_frames=40)),
}


def _demux(api, path, native):
    old = os.environ.get("MINIVIDEO_TPU_NO_NATIVE")
    os.environ["MINIVIDEO_TPU_NO_NATIVE"] = "0" if native else "1"
    try:
        m = api.mv_open(path)
        ok = api.mv_parse(m)
        api.mv_close(m)
    finally:
        if old is None:
            os.environ.pop("MINIVIDEO_TPU_NO_NATIVE")
        else:
            os.environ["MINIVIDEO_TPU_NO_NATIVE"] = old
    return ok, m


def _assert_same_value(want, got, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert want.dtype == got.dtype, f"{what}: {want.dtype} {got.dtype}"
        np.testing.assert_array_equal(want, got, err_msg=what)
    else:
        # enums of the two packages compare by value
        assert want == got, f"{what}: {want!r} != {got!r}"


def _assert_same_media(want, got):
    for f in dataclasses.fields(want):
        if f.name in ("file_handle", "tracks_audio", "tracks_video",
                      "tracks_subtitles", "tracks_others"):
            continue
        _assert_same_value(getattr(want, f.name), getattr(got, f.name),
                           f.name)
    assert [len(want.tracks_video), len(want.tracks_audio),
            len(want.tracks_subtitles), len(want.tracks_others)] == \
        [len(got.tracks_video), len(got.tracks_audio),
         len(got.tracks_subtitles), len(got.tracks_others)]
    for i, (tw, tg) in enumerate(zip(want.tracks, got.tracks)):
        # every attribute: the dataclass fields and those a demuxer adds
        # (fragments, wave_fmt, wave_cue_points, ...)
        assert sorted(vars(tw)) == sorted(vars(tg))
        for k in vars(tw):
            _assert_same_value(getattr(tw, k), getattr(tg, k),
                               f"track {i} {k}")


@pytest.mark.parametrize("name", sorted(FILES))
def test_demux_tables_equal_jax_package(name, annexb, tmp_path):
    """Python and native demuxers of both packages, column by column."""
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api as port_api
    fname, write = FILES[name]
    path = str(tmp_path / fname)
    with open(path, "wb") as f:
        f.write(write(annexb))
    for native in (False, True):
        ok_want, want = _demux(jax_api, path, native)
        ok_got, got = _demux(port_api, path, native)
        assert ok_want and ok_got, (name, native)
        assert want.tracks, name
        _assert_same_media(want, got)
    # the port's native path really ran demux.cc: its direct call agrees
    from minivideo_tpu_torch.containers.native import (native_demux,
                                                       native_demux_available)
    direct = port_api.mv_open(path)
    assert native_demux_available(direct.container)
    assert native_demux(direct)
    port_api.mv_close(direct)
    _assert_same_media(got, direct)


_TORCH_FREE = r"""
import json, sys
sys.path.insert(0, REPO)
import minivideo_tpu_torch.api, minivideo_tpu_torch.containers.filter
import minivideo_tpu_torch.containers.native
import minivideo_tpu_torch.testing.containers
from minivideo_tpu_torch.containers import (avi, es, mkv, mp3, mp4, mpeg_ps,
                                            pes, riff, ts, wave)
import minivideo_tpu_torch.muxer.muxer, minivideo_tpu_torch.profiling
import minivideo_tpu_torch.export.image, minivideo_tpu_torch.parallel
from minivideo_tpu_torch.apps import analyser, extractor, thumbnailer
print(json.dumps({"torch": "torch" in sys.modules}))
"""


def test_host_layer_imports_no_torch():
    """Opening, demuxing and extracting load no torch, nor do the apps,
    the batch pipeline and the export writers until they decode: a
    process that only demuxes (test_containers.py's bounded-memory
    subprocess, a demux tool) keeps its memory."""
    r = subprocess.run([sys.executable, "-c",
                        "REPO = %r\n" % REPO + _TORCH_FREE],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"torch": False}

"""The port's three apps and mv_extract against the JAX package's, on the
CPU, with tolerance 0 (byte-identical files and output): the thumbnailer
(`--device cpu`) against the JAX app (`--engine np`) for every format and
extraction mode, a missing input, the extractor's ES and PES from MP4,
Matroska and MPEG-TS files, the analyser's JSON, tables, hex dump and
FourCC helper, and mv_extract.

The clip is cropped to 76x42, an even crop: the port converts the RGB
formats on the decode's device from the uncropped planes and crops
(want_rgb), the JAX app's np engine converts the cropped planes on the
host, and the two agree at even crops only (ROADMAP §C triage note).
(The port is imported inside the tests: see torch_port_helpers.py.)"""

import os

import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream

WRITERS = {
    "mp4": lambda s: C.write_mp4(s, 80, 64),
    "mkv": lambda s: C.write_mkv(s, 80, 64),
    "ts": C.write_ts,
}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    data = make_stream(width_mbs=5, height_mbs=4, n_pictures=4, seed=81,
                       profile=100, transform_8x8=True,
                       mb_kinds=("i16", "i4", "i8"), crop=(1, 1, 0, 11))
    out = {"es": d / "clip.264"}
    out["es"].write_bytes(data)
    for fmt, write in WRITERS.items():
        out[fmt] = d / f"clip.{fmt}"
        out[fmt].write_bytes(write(data))
    return {k: str(v) for k, v in out.items()}


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _same_outputs(port_out, jax_out, port_dir, jax_dir):
    """Both apps printed the same file names, and the files are equal."""
    got = [os.path.relpath(p, port_dir) for p in port_out.split()]
    want = [os.path.relpath(p, jax_dir) for p in jax_out.split()]
    assert got == want and got
    for name in got:
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    return got


@pytest.mark.parametrize("fmt,mode", [
    ("png", "unfiltered"), ("jpg", "unfiltered"), ("bmp", "unfiltered"),
    ("tga", "unfiltered"), ("yuv420", "unfiltered"),
    ("yuv444", "unfiltered"), ("yuv420", "ordered"),
    ("yuv420", "distributed"), ("png", "distributed")])
def test_thumbnailer_is_the_jax_app_s(clips, tmp_path, capsys, fmt, mode):
    from minivideo_tpu.apps.thumbnailer import main as jax_main
    from minivideo_tpu_torch.apps.thumbnailer import main
    args = ["-i", clips["mp4"], "-f", fmt, "-n", "3", "-e", mode, "-q", "60"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    rc, out, err = _run(main, args + ["-o", port_dir, "--device", "cpu"],
                        capsys)
    assert rc == 0, err
    jrc, jout, jerr = _run(jax_main, args + ["-o", jax_dir,
                                             "--engine", "np"], capsys)
    assert jrc == 0, jerr
    names = _same_outputs(out, jout, port_dir, jax_dir)
    assert len(names) == 3


def test_thumbnailer_missing_input_exits_1(tmp_path, capsys):
    from minivideo_tpu_torch.apps.thumbnailer import main
    rc, out, err = _run(main, ["-i", str(tmp_path / "none.mp4"), "-o",
                               str(tmp_path), "--device", "cpu"], capsys)
    assert rc == 1 and "not found" in err and out == ""


@pytest.mark.parametrize("container", ["mp4", "mkv", "ts"])
def test_extractor_is_the_jax_app_s(clips, tmp_path, capsys, container):
    """ES and PES of the video track, and the default (every track)."""
    from minivideo_tpu.apps.extractor import main as jax_main
    from minivideo_tpu_torch.apps.extractor import main
    for extra in (["-v"], ["-v", "--pes"], []):
        tag = "_".join(extra) or "all"
        port_dir = str(tmp_path / f"port{tag}")
        jax_dir = str(tmp_path / f"jax{tag}")
        args = ["-i", clips[container], *extra]
        rc, out, err = _run(main, args + ["-o", port_dir], capsys)
        assert rc == 0, err
        jrc, jout, jerr = _run(jax_main, args + ["-o", jax_dir], capsys)
        assert jrc == 0, jerr
        _same_outputs(out, jout, port_dir, jax_dir)


@pytest.mark.parametrize("container", ["mp4", "ts"])
def test_analyser_is_the_jax_app_s(clips, capsys, container):
    """The summary and its JSON, the sample table, the bitrate graph,
    the hex dump of a sample and the FourCC helper."""
    from minivideo_tpu.apps.analyser import main as jax_main
    from minivideo_tpu_torch.apps.analyser import main
    path = clips[container]
    for argv in ([path], [path, "--json"], [path, "--samples", "0"],
                 [path, "--samples", "0", "--json", "--limit", "5"],
                 [path, "--bitrate", "0"], [path, "--hex", "0:1:48"],
                 ["--fourcc", "avc1"], ["--fourcc", "0x61766331", "--json"]):
        got = _run(main, list(argv), capsys)
        want = _run(jax_main, list(argv), capsys)
        assert got == want and got[0] == 0 and got[1], argv
    assert _run(main, [path + ".missing"], capsys)[0] == 1


def test_mv_extract_is_the_jax_package_s(clips, tmp_path):
    """mv_extract to a directory (named from the codec) and to a file
    path, as ES and as PES."""
    from minivideo_tpu import api as jax_api
    from minivideo_tpu_torch import api
    for container in ("mp4", "mkv", "ts"):
        for fmt in ("es", "pes"):
            outs = []
            for pkg, tag in ((api, "port"), (jax_api, "jax")):
                d = tmp_path / f"{tag}_{container}_{fmt}"
                d.mkdir()
                media = pkg.mv_open(clips[container])
                try:
                    assert pkg.mv_parse(media)
                    track = media.tracks_video[0]
                    a = pkg.mv_extract(media, track, str(d), fmt)
                    b = pkg.mv_extract(media, track, str(d / "named"), fmt)
                finally:
                    pkg.mv_close(media)
                outs.append((os.path.basename(a), open(a, "rb").read(),
                             open(b, "rb").read()))
            assert outs[0] == outs[1], (container, fmt)
            assert outs[0][1] == outs[0][2]

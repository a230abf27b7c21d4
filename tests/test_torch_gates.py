"""The port's quality gates: its native build argvs carry the JAX
package's Makefile flags and compile at -Werror; the library override
MINIVIDEO_TPU_TORCH_NATIVE_LIB loads one library for all three loaders,
builds nothing and decodes as the JAX package does, and a missing path
raises; tools/asan_check_torch.sh passes and its negative control
aborts; the exercise runs with torch, JAX and the JAX package blocked;
the mvt-* console scripts resolve to the port's apps and answer --help
with JAX blocked; and chip_smoke.py's app_outputs of the port's
extractor and analyser equal the JAX apps' on AVI and MPEG-PS files.
(The port is imported inside the tests: see torch_port_helpers.py.)"""

import os
import re
import subprocess
import sys
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_JAX = ("import sys\n"
             "for n in ('jax', 'jaxlib', 'minivideo_tpu'):\n"
             "    sys.modules[n] = None\n")


def _makefile_flags():
    """CXXFLAGS of minivideo_tpu/native/Makefile, with its -march test's
    result in place of $(MARCH) and without $(CXXFLAGS_EXTRA)."""
    from minivideo_tpu_torch import native
    text = open(os.path.join(REPO, "minivideo_tpu", "native",
                             "Makefile")).read()
    line = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1)
    flags = []
    for f in line.split():
        if f == "$(MARCH)":
            flags += native._march()
        elif f != "$(CXXFLAGS_EXTRA)":
            flags.append(f)
    return flags


def test_build_argvs_carry_the_makefile_flags(monkeypatch):
    """Each of the three builds runs native.cxx_argv, whose flags are the
    Makefile's in its order, and only the encoders link zlib."""
    from minivideo_tpu_torch import native
    flags = _makefile_flags()
    assert "-march=native" in flags or not native._march()
    seen = {}

    def fake_build(name, sources, cmd, **kw):
        seen[name] = cmd("OUT", sources)
        return "unused"
    monkeypatch.setattr(native, "build_shared", fake_build)
    native.build(), native.build_demux(), native.build_export()
    assert set(seen) == set(native.libraries()) == {
        "mvt_entropy", "mvt_demux", "mvt_export"}
    for name, argv in seen.items():
        srcs, libs = native.libraries()[name]
        assert argv == ["g++", *flags, "-shared", "-o", "OUT", *srcs, *libs]
        assert argv == native.cxx_argv("OUT", srcs, libs)
    assert native.libraries()["mvt_export"][1] == ["-lz"]


@pytest.mark.parametrize("name", ["mvt_entropy", "mvt_demux", "mvt_export"])
def test_native_source_compiles_at_werror(name, tmp_path):
    """The lint's build: the port's own argv plus -Werror."""
    from minivideo_tpu_torch import native
    srcs, libs = native.libraries()[name]
    out = str(tmp_path / f"lib{name}.so")
    r = subprocess.run(native.cxx_argv(out, srcs, libs) + ["-Werror"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert os.path.getsize(out) > 0


def _reset_loaders(monkeypatch, native):
    for name in ("_lib", "_demux_lib", "_export_lib"):
        monkeypatch.setattr(native, name, None)
    native._override_lib.cache_clear()


def test_override_loads_one_library_and_builds_nothing(tmp_path,
                                                       monkeypatch):
    """All three loaders return the one override library and nothing is
    built; a decode through it (native demux, native slab parse, the
    native JPEG) gives the JAX package's planes and bytes."""
    from fixtures import containers as C
    from fixtures.h264enc import make_stream
    from minivideo_tpu import api as jax_api
    from minivideo_tpu import native as jax_native
    from minivideo_tpu_torch import api, native
    from minivideo_tpu_torch.containers import native as port_demux
    from torch_port_helpers import assert_planes_equal
    lib = str(tmp_path / "libmvt_all.so")
    srcs = [s for s, _ in native.libraries().values()]
    r = subprocess.run(native.cxx_argv(lib, sum(srcs, []), ["-lz"]),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]

    def no_build(*a, **k):
        raise AssertionError("built a library under the override")
    monkeypatch.setattr(native, "build_shared", no_build)
    monkeypatch.setenv(native.OVERRIDE_ENV, lib)
    monkeypatch.delenv("MINIVIDEO_TPU_NO_NATIVE", raising=False)
    _reset_loaders(monkeypatch, native)
    loaded = native.load()
    assert native.load_demux() is loaded and native.load_export() is loaded
    assert loaded._name == lib

    demuxed = []
    real = port_demux.native_demux
    monkeypatch.setattr(port_demux, "native_demux",
                        lambda m: demuxed.append(real(m)) or demuxed[-1])
    path = str(tmp_path / "clip.mp4")
    with open(path, "wb") as f:
        f.write(C.write_mp4(make_stream(
            width_mbs=5, height_mbs=3, n_pictures=2, seed=41, profile=100,
            transform_8x8=True, mb_kinds=("i16", "i4", "i8")), 80, 48))
    got, want = api.mv_open(path), jax_api.mv_open(path)
    try:
        assert api.mv_parse(got, audio=False, subs=False) and demuxed == [
            True]
        assert jax_api.mv_parse(want, audio=False, subs=False)
        pics = api.mv_decode(got, picture_number=2, device="cpu")
        ref = jax_api.mv_decode(want, picture_number=2, engine="np")
    finally:
        api.mv_close(got)
        jax_api.mv_close(want)
    assert len(pics) == len(ref) == 2
    for i, (g, w) in enumerate(zip(pics, ref)):
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr), f"pic {i}")
        assert native.encode_jpeg_native(*g.cropped(), 75) == \
            jax_native.encode_jpeg_native(*w.cropped(), 75)


def test_missing_override_raises(tmp_path, monkeypatch):
    """A path that does not exist raises in every loader: nothing falls
    back to the normal build."""
    from minivideo_tpu_torch import native

    def no_build(*a, **k):
        raise AssertionError("fell back to the normal build")
    monkeypatch.setattr(native, "build_shared", no_build)
    monkeypatch.setenv(native.OVERRIDE_ENV, str(tmp_path / "missing.so"))
    _reset_loaders(monkeypatch, native)
    for loader in (native.load, native.load_demux, native.load_export):
        with pytest.raises(FileNotFoundError, match="missing.so"):
            loader()


def test_asan_gate_passes_and_its_control_aborts():
    """One round of the ASan gate: the negative control must abort with
    an ASan report, then the exercise runs clean."""
    r = subprocess.run(["bash", os.path.join(REPO, "tools",
                                             "asan_check_torch.sh"), "1"],
                       capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "negative control aborted (exit" in out
    assert "AddressSanitizer: heap-buffer-overflow" in out
    for line in ("entropy: ", "from 8 threads", "demux: ", "export: ",
                 "asan exercise: done", "asan: OK"):
        assert line in out, line
    assert "ERROR: AddressSanitizer" not in out.split(
        "exercising the port's native libraries")[1]


def test_exercise_runs_with_torch_and_jax_blocked(tmp_path):
    """The exercise, without ASan and with the normal builds, in a process
    where torch, JAX and the JAX package cannot be imported: it blocks
    them before its first import of the port."""
    exe = os.path.join(REPO, "tools", "asan_exercise_torch.py")
    src = open(exe).read()
    assert src.index("sys.modules[_name] = None") < src.index(
        "from minivideo_tpu_torch")
    r = subprocess.run([sys.executable, exe, "1"], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    counts = re.search(r"entropy: (\d+) clean parses, (\d+) clean errors",
                       r.stdout)
    assert counts and int(counts[1]) > 0 and int(counts[2]) > 0
    assert re.search(r"demux: (\d+) native demuxes", r.stdout)
    assert "asan exercise: done" in r.stdout


@pytest.mark.parametrize("script,app", [("mvt-thumbnail", "thumbnailer"),
                                        ("mvt-extract", "extractor"),
                                        ("mvt-analyse", "analyser")])
def test_console_script_is_the_port_app(script, app):
    """pyproject.toml's entry resolves to the port's app, whose
    main(["--help"]) exits 0 with JAX and the JAX package blocked."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    target = f"minivideo_tpu_torch.apps.{app}:main"
    assert scripts[script] == target
    assert scripts[script.replace("mvt-", "mv-")] == \
        target.replace("minivideo_tpu_torch", "minivideo_tpu")
    mod, fn = target.split(":")
    code = (BLOCK_JAX + f"sys.path.insert(0, {REPO!r})\n"
            f"from {mod} import {fn}\n"
            "try:\n"
            f"    {fn}(['--help'])\n"
            "except SystemExit as e:\n"
            "    sys.exit(e.code)\n"
            "sys.exit(3)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "usage" in r.stdout


@pytest.mark.parametrize("ext", ["avi", "mpg"])
def test_app_outputs_are_the_jax_apps(ext, tmp_path):
    """chip_smoke.app_outputs (the files phase's check) of the port's
    extractor and analyser equal the JAX apps' on a CAVLC and a CABAC
    batch written by the port's AVI and MPEG-PS writers, whose bytes are
    the fixture writers'."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from fixtures import containers as FC
    from fixtures.h264enc import make_stream
    from fixtures.h264enc2 import make_stream2
    from minivideo_tpu.apps import analyser as jax_analyser
    from minivideo_tpu.apps import extractor as jax_extractor
    from minivideo_tpu_torch.apps import analyser, extractor
    streams = {
        "cavlc": make_stream(width_mbs=5, height_mbs=3, n_pictures=3,
                             seed=51, profile=100, transform_8x8=True,
                             mb_kinds=("i16", "i4", "i8")),
        "cabac": make_stream2(width_mbs=5, height_mbs=3, n_pictures=3,
                              seed=52, entropy="cabac",
                              transform_8x8=True)}
    files = chip_smoke.write_container_files(str(tmp_path), streams)
    for entropy, data in streams.items():
        path = files[entropy, ext]
        with open(path, "rb") as f:
            fixture = (FC.write_avi(data, 1920, 1088) if ext == "avi"
                       else FC.write_ps(data))
            assert f.read() == fixture
        got = chip_smoke.app_outputs(extractor, analyser, path)
        want = chip_smoke.app_outputs(jax_extractor, jax_analyser, path)
        assert got == want and len(got["es"]) == len(got["pes"]) == 1


PNG_UNDER_CAP = r"""
import ctypes, resource, sys
import numpy as np
from minivideo_tpu_torch import native
lib = native.load_export()                  # built before the cap
h, w = 4096, 4096
rgb = np.random.default_rng(7).integers(0, 256, (h, w, 3), np.uint8)
cap = h * (w * 3 + 1) + (1 << 20)
out = np.empty(cap, np.uint8)
p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
vm = [int(x.split()[1]) for x in open("/proc/self/status")
      if x.startswith("VmSize:")][0] * 1024
# room for the bands' threads, not for their filter and deflate buffers
# (4 bands of 12.6 MB each, twice)
resource.setrlimit(resource.RLIMIT_AS, (vm + (40 << 20), -1))
n = lib.mv_encode_png(p(rgb), h, w, 3, 4, p(out), cap)
print("code", n)
sys.exit(0 if n < 0 else 1)
"""


def test_png_bands_fail_without_ending_the_process():
    """An allocation that fails inside a PNG band's thread (export.cc
    PngBand, here under an address-space cap) makes mv_encode_png return
    an error code, which encode_png_native raises as a failed picture,
    in place of std::terminate ending the process."""
    from minivideo_tpu_torch import native
    native.load_export()
    r = subprocess.run([sys.executable, "-c", PNG_UNDER_CAP], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-2000:])
    assert re.search(r"code -[23]$", r.stdout.strip()), r.stdout

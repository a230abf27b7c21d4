"""The port stands alone: it imports and decodes with JAX and the JAX
package blocked (with every engine: fused, wave and np; the bench too),
chip_smoke.py imports neither, the port's encoders emit
the fixture encoders' bytes, and chip_smoke.py's constants are the JAX
package's digests of its 1080p stream (the CABAC stream's digests are
checked in test_torch_parsers.py, so that xdist runs the two long tests
in different workers)."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "minivideo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "minivideo_tpu", "tests", "fixtures")

_BLOCK = r"""
import sys
for name in ("jax", "jaxlib", "minivideo_tpu"):
    sys.modules[name] = None
sys.path.insert(0, REPO)
"""
_BLOCKED_RUN = r"""
import importlib, json, pkgutil
import minivideo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    minivideo_tpu_torch.__path__, "minivideo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from minivideo_tpu_torch.testing.h264enc import make_stream
from minivideo_tpu_torch.models.h264.decoder import decode_annexb
data = make_stream(width_mbs=4, height_mbs=3, n_pictures=2, seed=11,
                   profile=100, transform_8x8=True,
                   mb_kinds=("i16", "i4", "i8"))
pics = decode_annexb(data, device="cpu")
same = [all((a.y == b.y).all() and (a.cb == b.cb).all()
            and (a.cr == b.cr).all() for a, b in
            zip(pics, decode_annexb(data, engine=e, device="cpu")))
        for e in ("wave", "np")]
import numpy as np, subprocess, torch
from minivideo_tpu_torch.models.h264.recon_np import reconstruct_frame
from minivideo_tpu_torch.ops.recon import pack_frames
from minivideo_tpu_torch.parallel import halo, multihost, sharding
mesh = sharding.Mesh(np.array(["cpu"] * 4, dtype=object), ("lanes",))
parsed = [multihost._parse_clip_syntax(c)
          for c in multihost._clip_streams(2)]
planes = halo.reconstruct_frames_halo(pack_frames(
    [(fs, som) for fs, _, _, som in parsed], parsed[0][1], parsed[0][2]),
    mesh)
halo_ok = all(torch.equal(planes[0][i], torch.as_tensor(
    reconstruct_frame(*parsed[i])[0])) for i in range(2))
# the workers, each with JAX and the JAX package blocked too
init = multihost.free_init_method()
worker = BLOCK + (
    "from minivideo_tpu_torch.parallel.multihost import main\n"
    "main(sys.argv[1:])\n"
    "assert not [n for n in sys.modules if sys.modules[n] is not None\n"
    "            and n.split('.')[0] in ('jax', 'jaxlib', 'minivideo_tpu')]\n"
    "print('WORKER CLEAN')\n")
procs = [subprocess.Popen(
    [sys.executable, "-c", worker,
     *multihost.worker_argv(i, 2, init, 2, "cpu")],
    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for i in range(2)]
outs = [p.communicate(timeout=240)[0] for p in procs]
workers = [p.returncode == 0 and "MULTIHOST OK" in o and "WORKER CLEAN" in o
           for p, o in zip(procs, outs)]
# the bench at a small size on the CPU (one intra-op thread: its loops of
# small torch ops run faster on one), its stream cache in a scratch dir
import shutil, tempfile
from minivideo_tpu_torch import bench
torch.set_num_threads(1)
bench.CACHE = tempfile.mkdtemp()
try:
    res = bench.run(["--device", "cpu", "--size", "96x64", "--batch", "2",
                     "--iters", "3", "--runs", "1"])
finally:
    shutil.rmtree(bench.CACHE)
bench_ok = (res["output_check"] == "bit-exact" and res["checked_runs"] == 4
            and res["transfer_included"] and res["value"] > 0)
import chip_smoke
loaded = sorted(n for n in sys.modules
                if sys.modules[n] is not None
                and n.split(".")[0] in ("jax", "jaxlib", "minivideo_tpu"))
print(json.dumps({"modules": len(mods), "pictures": len(pics),
                  "shape": list(pics[0].y.shape), "loaded": loaded,
                  "same": same, "halo": halo_ok, "workers": workers,
                  "bench": bench_ok,
                  "worker_out": [o[-1500:] for o in outs]}))
"""


def test_port_runs_with_jax_blocked():
    """Every module of the port imports, decodes with each engine, runs
    a halo over 4 CPU strips, two multihost workers (themselves with
    both blocked) and the bench (`--device cpu`, 6x4 MBs, batch 2, 3
    iterations) with JAX and the JAX package blocked."""
    head = "REPO = %r\n" % REPO + _BLOCK
    code = head + "BLOCK = %r\n" % head + _BLOCKED_RUN
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["pictures"] == 2 and out["shape"] == [48, 64]
    assert out["modules"] >= 70 and out["loaded"] == []
    assert out["same"] == [True, True]
    assert out["halo"], "halo planes differ from recon_np"
    assert out["workers"] == [True, True], out["worker_out"]
    assert out["bench"], "the bench's checks or figures failed"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_sources_import_nothing_of_jax():
    bad = {os.path.relpath(path, REPO): m for path in _sources()
           for m in _imports(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"forbidden imports: {bad}"
    assert len(list(_sources())) >= 20


@pytest.mark.parametrize("kw", [
    dict(),
    dict(width_mbs=6, height_mbs=4, n_pictures=2, seed=3, profile=100,
         transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3),
    dict(width_mbs=5, height_mbs=5, n_pictures=2, seed=4, qp=51,
         allow_pcm=True, crop=(0, 2, 0, 2)),
    dict(width_mbs=4, height_mbs=3, n_pictures=1, seed=5, profile=100,
         transform_8x8=True, mb_kinds=("i8",),
         scaling_lists=[(1, None)] * 8,
         pps_scaling_lists=[(1, list(range(8, 24)))] * 8),
])
def test_encoder_copy_emits_fixture_bytes(kw):
    """The encoder's stream, and that stream in every container that the
    port's copy of the fixture writers builds (testing/containers.py)."""
    # imported here, not at collection (see torch_port_helpers.py)
    from fixtures import containers as fixture
    from fixtures.h264enc import make_stream as fixture_stream
    from minivideo_tpu_torch.testing import containers
    from minivideo_tpu_torch.testing.h264enc import make_stream
    data = make_stream(**kw)
    assert data == fixture_stream(**kw)
    w, h = 16 * kw.get("width_mbs", 4), 16 * kw.get("height_mbs", 3)
    for name, args in (("write_mp4", (w, h)), ("write_mkv", (w, h)),
                       ("write_ts", ()), ("write_avi", (w, h)),
                       ("write_ps", ())):
        assert getattr(containers, name)(data, *args) == \
            getattr(fixture, name)(data, *args), name
    assert containers.write_mp4(data, w, h, visual_ext=True) == \
        fixture.write_mp4(data, w, h, visual_ext=True)
    assert containers.write_mkv(data, w, h, lacing="xiph") == \
        fixture.write_mkv(data, w, h, lacing="xiph")
    assert containers.write_avi(data, w, h, opendml=True) == \
        fixture.write_avi(data, w, h, opendml=True)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(width_mbs=5, height_mbs=4, n_pictures=2, seed=3, entropy="cabac",
         mb_kinds=("i16", "i4", "i8"), transform_8x8=True, allow_pcm=True,
         n_slices=3),
    dict(width_mbs=6, height_mbs=3, n_pictures=2, seed=4, qp=40,
         mb_kinds=("i16", "i4", "i8"), transform_8x8=True, allow_pcm=True,
         n_slices=2, density=0.6),
    dict(width_mbs=4, height_mbs=4, n_pictures=2, seed=5, qp=0,
         entropy="cabac", mb_kinds=("i16",), allow_pcm=True),
    dict(width_mbs=4, height_mbs=3, n_pictures=2, seed=6, qp=51,
         entropy="cabac", mb_kinds=("i4", "i8"), transform_8x8=True),
    dict(width_mbs=3, height_mbs=3, n_pictures=1, seed=7, entropy="cabac",
         mb_kinds=("i16", "i4"), density=0.9, max_level=3000),
    dict(width_mbs=3, height_mbs=3, n_pictures=1, seed=8,
         mb_kinds=("i16", "i4"), density=0.9, max_level=1000),
])
def test_encoder2_copy_emits_fixture_bytes(kw):
    """Both entropy coders, QP extremes and escape-range levels."""
    from fixtures.h264enc2 import make_stream2 as fixture_stream2
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    assert make_stream2(**kw) == fixture_stream2(**kw)


@pytest.mark.parametrize("name", ["truncated_idr", "joined_id0",
                                  "error_run"])
def test_bad_streams_are_the_fixture_s(name):
    """chip_smoke.py pins the JAX package's pictures of these streams, so
    the port's encoder must build them byte for byte as the fixture's."""
    from fixtures.h264enc import make_stream as fixture_stream
    from minivideo_tpu_torch.testing.h264enc import make_stream
    from minivideo_tpu_torch.testing.streams import bad_stream
    assert bad_stream(name, make_stream) == bad_stream(name, fixture_stream)


def test_chip_smoke_digests_are_the_jax_package_s(monkeypatch, tmp_path):
    """The 1080p stream's SHA-256, the per-picture plane digests and the
    RGB digests in chip_smoke.py equal what the fixture encoder and the
    JAX package's fused engine (device staging, want_rgb) give, and the
    port's CPU decode of the stream gives them too.  So do the thumbnails
    phase's pins: the JAX package's native JPEG of each picture
    (JPEG_DIGESTS), the small clip's planes (SMALL_DIGESTS) and the ES
    that mv_extract writes from the 16-picture MP4 (ES_SHA256); and
    chip_smoke.png_pixels reads back the pixels of both packages' PNG
    writers."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from fixtures.h264enc import make_stream
    from minivideo_tpu.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch.models.h264.decoder import (
        decode_annexb as port_decode)
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "device")
    data = make_stream(**chip_smoke.STREAM_KW)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.STREAM_SHA256

    def digests(pics):
        return [[hashlib.sha256(np.ascontiguousarray(a).tobytes())
                 .hexdigest() for a in (p.y, p.cb, p.cr)] for p in pics]

    def rgb_digests(pics):
        return [hashlib.sha256(np.ascontiguousarray(p.rgb).tobytes())
                .hexdigest() for p in pics]

    want = decode_annexb(data, engine="fused", want_rgb=True)
    assert digests(want) == chip_smoke.JAX_DIGESTS
    assert rgb_digests(want) == chip_smoke.RGB_DIGESTS
    got = port_decode(data, device="cpu", want_rgb=True)
    assert digests(got) == chip_smoke.JAX_DIGESTS
    assert rgb_digests(got) == chip_smoke.RGB_DIGESTS
    assert len(chip_smoke.JAX_DIGESTS) == chip_smoke.STREAM_KW["n_pictures"]

    from fixtures import containers
    from minivideo_tpu import api, native
    from minivideo_tpu.export import image
    from minivideo_tpu_torch import api as port_api
    from minivideo_tpu_torch import native as port_native
    from minivideo_tpu_torch.testing.streams import repeat_pictures
    jpeg = [hashlib.sha256(native.encode_jpeg_native(*p.cropped(), 75))
            .hexdigest() for p in want]
    assert jpeg == chip_smoke.JPEG_DIGESTS
    assert [hashlib.sha256(port_native.encode_jpeg_native(*p.cropped(), 75))
            .hexdigest() for p in got] == jpeg
    small = make_stream(**chip_smoke.THUMB_SMALL_KW)
    assert digests(decode_annexb(small, engine="fused"))[0] == \
        chip_smoke.SMALL_DIGESTS
    assert digests(port_decode(small, device="cpu"))[0] == \
        chip_smoke.SMALL_DIGESTS
    mp4 = tmp_path / "c.mp4"
    mp4.write_bytes(containers.write_mp4(repeat_pictures(data, 8), 1920,
                                         1088))
    for pkg, tag in ((api, "jax"), (port_api, "port")):
        media = pkg.mv_open(str(mp4))
        assert pkg.mv_parse(media)
        (tmp_path / tag).mkdir()
        es = pkg.mv_extract(media, media.tracks_video[0],
                            str(tmp_path / tag), "es")
        pkg.mv_close(media)
        assert hashlib.sha256(open(es, "rb").read()).hexdigest() == \
            chip_smoke.ES_SHA256, tag
    png = tmp_path / "p.png"
    png.write_bytes(native.encode_png_native(want[0].rgb))
    np.testing.assert_array_equal(chip_smoke.png_pixels(str(png)),
                                  want[0].rgb)
    image.write_png_py(str(png), want[1].rgb[:40, :24])
    np.testing.assert_array_equal(chip_smoke.png_pixels(str(png)),
                                  want[1].rgb[:40, :24])


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the script exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

"""The port's batch pipeline (parallel/batch.py, manifest.py,
profiling.py) against the JAX package's, on the CPU, with tolerance 0:
batch_thumbnail(device="cpu") and the JAX package's
batch_thumbnail(engine="fused") over the same small clips write the same
files and the same manifest.  The clips cover two geometries (two
buckets), MP4, Matroska, MPEG-TS and ES files, a clip whose slice data is
corrupt after its headers (its frame reconstructs black, the owning clip
fails) and one that fails to demux; the runs cover both slab layouts
(device and records) and the raster path of MINIVIDEO_TPU_NO_NATIVE=1,
resume from the manifest with a torn line, process_index/process_count,
StageTimer and device_trace.

The JAX runs reconstruct in Pallas interpret mode, seconds each, so each
configuration runs once per module and the tests share it.  (The port is
imported inside the tests and fixtures: see torch_port_helpers.py.)"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream

KW = dict(n_pictures=2, mb_kinds=("i16", "i4"), density=0.4,
          allow_pcm=False)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Sorted clip paths: 5x4-MB clips as ES, MP4 and Matroska, a 4x3-MB
    MPEG-TS clip (a second bucket), a 5x4-MB clip whose slice data is
    spoiled after the headers, and garbage that probes as H.264 ES."""
    d = tmp_path_factory.mktemp("clips")
    (d / "c0.264").write_bytes(make_stream(width_mbs=5, height_mbs=4,
                                           seed=60, **KW))
    (d / "c1.mp4").write_bytes(C.write_mp4(
        make_stream(width_mbs=5, height_mbs=4, seed=61, **KW), 80, 64))
    (d / "c2.mkv").write_bytes(C.write_mkv(
        make_stream(width_mbs=5, height_mbs=4, seed=62, **KW), 80, 64))
    (d / "small.ts").write_bytes(C.write_ts(
        make_stream(width_mbs=4, height_mbs=3, seed=63, **KW)))
    data = bytearray(make_stream(width_mbs=5, height_mbs=4, seed=70, **KW))
    for pos in range(len(data) * 2 // 3, len(data) - 8, 3):
        data[pos] ^= 0xFF
    (d / "bad.264").write_bytes(bytes(data))
    (d / "garbage.264").write_bytes(b"\x00\x00\x00\x01\x67" + b"\x13" * 40)
    return sorted(str(p) for p in d.iterdir())


def _spy_run(pkg, clips, outdir, env, **kw):
    """batch_thumbnail of package `pkg` ("port" or "jax") under `env`,
    with its StageTimer and its _Recon outputs captured.  The port's
    device-mode staging starts full of 0x5A bytes, not zeros: its parser
    writes every MB it parses whole and the rest is zeroed after."""
    patches = []
    if pkg == "port":
        from minivideo_tpu_torch import profiling
        from minivideo_tpu_torch.codecs import PictureFormat
        from minivideo_tpu_torch.ops import recon as recon_mod
        from minivideo_tpu_torch.parallel import batch
        kw["device"] = "cpu"
        fresh = recon_mod.make_slab_staging2

        def dirty(*a):
            staging = fresh(*a)
            staging["records"].view(np.uint8)[...] = 0x5A
            return staging

        patches.append((recon_mod, "make_slab_staging2", dirty))
    else:
        from minivideo_tpu import profiling
        from minivideo_tpu import settings
        from minivideo_tpu.codecs import PictureFormat
        from minivideo_tpu.parallel import batch
        kw["engine"] = "fused"
    kw["fmt"] = PictureFormat[kw["fmt"]]
    timers, planes = [], []
    real = batch._Recon.__call__

    class Timer(profiling.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    def recon(self, packed, **k):
        out = real(self, packed, **k)
        planes.append([np.asarray(a) for a in out[:3]])
        return out

    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(profiling, "StageTimer", Timer)
        mp.setattr(batch._Recon, "__call__", recon)
        for obj, attr, fn in patches:
            mp.setattr(obj, attr, fn)
        if pkg == "jax":     # its settings snapshot reads the env once
            mp.setattr(settings, "_settings", None)
        res = batch.batch_thumbnail(clips, outdir, pictures_per_clip=2,
                                    **kw)
    return res, timers[0], planes


RUNS = {  # name -> (env, fmt)
    "device": ({"MINIVIDEO_TPU_STAGING": "device"}, "PNG"),
    "records": ({"MINIVIDEO_TPU_STAGING": "records"}, "YUV420"),
    "raster": ({"MINIVIDEO_TPU_NO_NATIVE": "1"}, "JPG"),
}


@pytest.fixture(scope="module")
def runs(clips, tmp_path_factory):
    """name -> {pkg: (outdir, BatchResult, StageTimer, recon planes)},
    computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            env, fmt = RUNS[name]
            cache[name] = {}
            for pkg in ("port", "jax"):
                out = str(tmp_path_factory.mktemp(f"{name}_{pkg}"))
                cache[name][pkg] = (out, *_spy_run(pkg, clips, out, env,
                                                   fmt=fmt))
        return cache[name]

    return get


def _manifest(outdir, name="manifest.0.jsonl"):
    """The manifest's records, without their times; a torn line (which
    Manifest skips) is kept as its text."""
    recs = []
    for line in open(os.path.join(outdir, name)):
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            recs.append({"clip": re.sub(r'"ts": [0-9.]+', "", line),
                         "status": "torn"})
    return [(r["clip"], r["status"], r.get("error"),
             [os.path.basename(o) for o in r.get("outputs", [])])
            for r in recs]


def _same_files(port_dir, jax_dir):
    names = sorted(f for f in os.listdir(jax_dir) if not f.endswith(".jsonl"))
    assert sorted(f for f in os.listdir(port_dir)
                  if not f.endswith(".jsonl")) == names
    for n in names:
        with open(os.path.join(port_dir, n), "rb") as a, \
                open(os.path.join(jax_dir, n), "rb") as b:
            assert a.read() == b.read(), n
    return names


@pytest.mark.parametrize("name", list(RUNS))
def test_batch_is_the_jax_package_s(runs, name):
    """Same files, manifest, counts and bucket planes as the JAX package;
    the corrupt clip and the garbage clip fail, the rest is done."""
    port, jax = runs(name)["port"], runs(name)["jax"]
    for f in ("done", "failed", "skipped", "frames"):
        assert getattr(port[1], f) == getattr(jax[1], f), f
    assert (port[1].done, port[1].failed, port[1].skipped) == (4, 2, 0)
    assert sorted(map(os.path.basename, port[1].outputs)) == \
        sorted(map(os.path.basename, jax[1].outputs))
    assert len(_same_files(port[0], jax[0])) == 8
    assert sorted(_manifest(port[0])) == sorted(_manifest(jax[0]))
    assert set(port[1].errors) == set(jax[1].errors)
    assert {os.path.basename(p) for p in port[1].errors} == \
        {"bad.264", "garbage.264"}
    # the bucket planes, row for row, the corrupt frames' rows included
    assert len(port[3]) == len(jax[3]) == 2
    for got, want in zip(port[3], jax[3]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["device", "records"])
def test_corrupt_frames_reconstruct_black(runs, name):
    """The slab paths zero a failed frame's rows (the device mode's
    records, on staging that held 0x5A bytes before the parse): its
    picture is black (all zero samples) in both packages, while the good
    clips' are not."""
    port, jax = runs(name)["port"], runs(name)["jax"]
    bad = [m for m in _manifest(port[0]) if m[0].endswith("bad.264")]
    assert bad and bad[0][1] == "failed" and bad[0][2].startswith("entropy")
    # bucket rows in clip order: bad.264's two pictures (the second
    # spoiled), then c0, c1 and c2's
    big = next(p for p in port[3] if p[0].shape[0] == 8)
    for plane in big:
        black = [i for i in range(8) if not plane[i].any()]
        assert black == [1]
    jbig = next(p for p in jax[3] if p[0].shape[0] == 8)
    for a, b in zip(big, jbig):
        np.testing.assert_array_equal(a, b)


def test_resume_and_torn_manifest(clips, runs, tmp_path):
    """A second call skips every done clip and retries the failures; a
    done line torn by a crash leaves its clip pending.  Both packages
    read and append to the same manifest alike.  (The first record
    appended after the torn line lands on that line and is lost on the
    next read: the JAX package's Manifest does that too, and the port
    keeps it.)"""
    from minivideo_tpu.parallel import Manifest as JaxManifest
    from minivideo_tpu_torch.parallel import Manifest
    src = runs("records")
    outs = {}
    for pkg in ("port", "jax"):
        out = str(tmp_path / pkg)
        shutil.copytree(src[pkg][0], out)
        man = os.path.join(out, "manifest.0.jsonl")
        lines = open(man).read().splitlines(keepends=True)
        last_done = max(i for i, l in enumerate(lines) if '"done"' in l)
        torn = json.loads(lines[last_done])["clip"]
        lines[last_done] = lines[last_done][:25]       # torn mid-write
        open(man, "w").write("".join(lines))
        outs[pkg] = _spy_run(pkg, clips, out, RUNS["records"][0],
                             fmt="YUV420")[0]
    for res in outs.values():
        assert (res.done, res.failed, res.skipped) == (1, 2, 3)
        assert {os.path.basename(p) for p in res.errors} == \
            {"bad.264", "garbage.264"}
    assert [os.path.basename(o) for o in outs["port"].outputs] == \
        [os.path.basename(o) for o in outs["jax"].outputs]
    assert os.path.basename(torn).split(".")[0] in \
        outs["port"].outputs[0]
    assert _manifest(str(tmp_path / "port")) == \
        _manifest(str(tmp_path / "jax"))
    with Manifest(str(tmp_path / "port" / "manifest.0.jsonl")) as a, \
            JaxManifest(str(tmp_path / "jax" / "manifest.0.jsonl")) as b:
        assert a.stats() == b.stats() == {"done": 4, "failed": 2}
        assert a.pending(clips) == b.pending(clips)
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_process_partition(clips, runs, tmp_path):
    """process_index/process_count: two processes take disjoint clips
    (clips[i::2]) with their own manifests, and together write the files
    of one process, byte for byte the JAX package's."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch_thumbnail
    jax_dir = runs("records")["jax"][0]
    out = str(tmp_path / "out")
    seen = []
    for pi in range(2):
        res = batch_thumbnail(clips, out, pictures_per_clip=2,
                              fmt=PictureFormat.YUV420, device="cpu",
                              process_index=pi, process_count=2)
        recs = _manifest(out, f"manifest.{pi}.jsonl")
        assert sorted(r[0] for r in recs) == sorted(clips[pi::2])
        assert res.done + res.failed == len(clips[pi::2])
        seen.append({os.path.basename(o) for o in res.outputs})
    assert not seen[0] & seen[1]
    assert len(_same_files(out, jax_dir)) == 8


def test_stage_timer_is_the_jax_package_s(runs):
    """The batch's StageTimer: the same stages and item counts as the
    JAX package's, and the same summary for the same times."""
    from minivideo_tpu.profiling import StageTimer as JaxTimer
    from minivideo_tpu_torch.profiling import StageTimer
    for name in RUNS:
        port, jax = runs(name)["port"][2], runs(name)["jax"][2]
        assert port.items == jax.items, name
        assert set(port.acc) == set(jax.acc)
    assert runs("device")["port"][2].items == {
        "parse": 6, "entropy": 10, "recon": 8, "export": 4}
    a, b = StageTimer(), JaxTimer()
    for t in (a, b):
        t.acc, t.items = {"parse": 0.5, "recon": 2.0, "x": 0.0}, \
            {"parse": 3, "recon": 8}
    assert a.summary() == b.summary() == \
        "recon: 2.000s (4.0/s) | parse: 0.500s (6.0/s) | x: 0.000s"


def test_device_trace_writes_chrome_traces(clips, tmp_path, monkeypatch):
    """MINIVIDEO_TPU_PROFILE=<dir>: one torch.profiler Chrome trace per
    bucket reconstruction; unset, no trace is taken."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.parallel import batch_thumbnail
    from minivideo_tpu_torch.profiling import device_trace
    prof = tmp_path / "prof"
    monkeypatch.setenv("MINIVIDEO_TPU_PROFILE", str(prof))
    res = batch_thumbnail(clips[:2], str(tmp_path / "a"), device="cpu",
                          fmt=PictureFormat.YUV420)
    assert res.done == 2
    traces = sorted(prof.iterdir())
    assert len(traces) == 1           # c0 and c1: one bucket
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    monkeypatch.delenv("MINIVIDEO_TPU_PROFILE")
    with device_trace():
        pass
    with device_trace(str(tmp_path / "explicit")):
        pass
    assert len(list(prof.iterdir())) == 1
    assert len(list((tmp_path / "explicit").iterdir())) == 1


def test_without_a_card_batch_and_thumbnailer_raise(clips, tmp_path):
    """device=None means the GPU: without one, batch_thumbnail and the
    thumbnailer raise before they write anything; neither falls back to
    the CPU."""
    import torch
    from minivideo_tpu_torch.apps.thumbnailer import main
    from minivideo_tpu_torch.parallel import batch_thumbnail
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_thumbnail(clips, str(tmp_path / "b"))
    assert not (tmp_path / "b").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-i", clips[1], "-o", str(tmp_path / "t")])
    assert not list((tmp_path / "t").iterdir())


def _fake_cards(monkeypatch, n):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("n,want", [(1, [["cuda:0"]]),
                                    (4, [["cuda:0", "cuda:1"],
                                         ["cuda:2", "cuda:3"]])])
def test_default_mesh_covers_every_card(tmp_path, monkeypatch, n, want):
    """With no mesh and no device, batch_thumbnail runs over
    make_mesh(): every card, as the JAX package's make_mesh() over every
    device; one card gives a 1x1 mesh of cuda:0.  (Cards are faked: a
    torch.device names a card without touching it, and no clip runs.)"""
    from minivideo_tpu_torch.parallel import batch
    _fake_cards(monkeypatch, n)
    meshes = []

    class Recon(batch._Recon):
        def __init__(self, mesh, engine):
            super().__init__(mesh, engine)
            meshes.append(mesh)

    monkeypatch.setattr(batch, "_Recon", Recon)
    batch.batch_thumbnail([], str(tmp_path))
    for mesh in (meshes[0], batch._mesh_of(None, None)):
        assert mesh.axis_names == ("data", "seq")
        assert [[str(d) for d in row] for row in mesh.devices] == want


def test_named_device_is_a_one_entry_mesh(tmp_path, monkeypatch):
    """A named device is a 1x1 mesh of it, whatever the card count; a
    mesh and a device together raise."""
    from minivideo_tpu_torch.parallel import batch, make_mesh
    _fake_cards(monkeypatch, 4)
    for name in ("cpu", "cuda:3"):
        mesh = batch._mesh_of(None, name)
        assert [[str(d) for d in row] for row in mesh.devices] == [[name]]
    with pytest.raises(ValueError, match="not both"):
        batch._mesh_of(make_mesh(devices=["cpu"] * 4), "cpu")


def test_mesh_launches_every_shard_before_one_check(clips, runs, tmp_path):
    """Over a 2x2 mesh the fused engine runs every shard unchecked
    (check=False), then one check_waits() before the readback, per
    bucket; the files and bucket planes are still the JAX package's."""
    from minivideo_tpu_torch.codecs import PictureFormat
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel import batch, make_mesh
    jax_dir, _, _, jax_planes = runs("device")["jax"]
    events, planes = [], []
    fused, check_waits = (recon_fused.reconstruct_frames_fused,
                          recon_fused.check_waits)
    real = batch._Recon.__call__

    def spy_fused(packed, device=None, check=True):
        events.append(("launch", check))
        return fused(packed, device, check=check)

    def spy_check(*words):
        events.append(("check", None))
        return check_waits(*words)

    def recon(self, packed, **k):
        out = real(self, packed, **k)
        planes.append([np.asarray(a) for a in out[:3]])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIVIDEO_TPU_STAGING", "device")
        mp.setattr(recon_fused, "reconstruct_frames_fused", spy_fused)
        mp.setattr(recon_fused, "check_waits", spy_check)
        mp.setattr(batch._Recon, "__call__", recon)
        out = str(tmp_path / "mesh")
        batch.batch_thumbnail(clips, out, pictures_per_clip=2,
                              mesh=make_mesh(devices=["cpu"] * 4),
                              fmt=PictureFormat.PNG)
    assert events == ([("launch", False)] * 4 + [("check", None)]) * 2
    _same_files(out, jax_dir)
    assert len(planes) == len(jax_planes) == 2
    for got, want in zip(planes, jax_planes):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_launch_counts_read_zero_after_a_cpu_run():
    """The wave kernel's launch count and its per-card dict read 0 and
    {} after the fused engine ran on the CPU (its plain loop) over a
    mesh of two entries, whose planes equal one device's."""
    from minivideo_tpu_torch.models.h264.decoder import (decode_annexb,
                                                         stage_annexb)
    from minivideo_tpu_torch.ops import recon_fused
    from minivideo_tpu_torch.parallel import make_mesh
    from minivideo_tpu_torch.parallel.batch import _Recon
    data = make_stream(width_mbs=4, height_mbs=3, seed=64, **KW)
    (_, packed), = stage_annexb(data, "cpu")
    recon_fused.wave_kernel_cuda.launches = 0
    recon_fused.wave_kernel_cuda.launches_by_device = {}
    got = _Recon(make_mesh(devices=["cpu"] * 2), "fused")(packed)
    assert recon_fused.wave_kernel_cuda.launches == 0
    assert recon_fused.wave_kernel_cuda.launches_by_device == {}
    for i, pic in enumerate(decode_annexb(data, device="cpu")):
        for a, b in zip(got, (pic.y, pic.cb, pic.cr)):
            np.testing.assert_array_equal(a[i], b)

"""The port's mesh sharding (minivideo_tpu_torch/parallel/sharding.py)
and the mesh path of its batch_thumbnail against the JAX package's, on
the CPU, with tolerance 0: make_mesh's axes, sizes and seq rules,
pad_to_multiple, shard_packed's placement against the frames that the
JAX batch_sharding puts on each device (addressable_shards), and
batch_thumbnail over a 2x2 mesh of CPU entries against the port on one
CPU device and the JAX package on a 4-device mesh, for device, records
and raster staging.  (The port is imported inside the tests: see
torch_port_helpers.py.)"""

import os

import numpy as np
import pytest

from fixtures import containers as C
from fixtures.h264enc import make_stream

KW = dict(n_pictures=2, mb_kinds=("i16", "i4"), density=0.4,
          allow_pcm=False)
MESH_CASES = [  # (n_devices, seq): None takes the default
    (None, None), (6, None), (5, None), (1, None), (8, 4), (4, 2)]


def _cpu_mesh(n=8, **kw):
    from minivideo_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(devices=["cpu"] * n, **kw)


@pytest.mark.parametrize("n_devices,seq", MESH_CASES)
def test_make_mesh_matches_jax(n_devices, seq):
    """Axis names, per-axis sizes and size equal the JAX make_mesh's on
    the 8 CPU devices."""
    from minivideo_tpu.parallel.sharding import make_mesh as jax_mesh
    want = jax_mesh(n_devices, seq)
    got = _cpu_mesh(n_devices=n_devices, seq=seq)
    assert got.axis_names == tuple(want.axis_names) == ("data", "seq")
    assert dict(got.shape) == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.devices.size == got.size == want.devices.size
    assert all(str(d) == "cpu" for d in got.devices.flat)


def test_make_mesh_refusals():
    """A seq that does not divide the count raises in both packages; the
    default devices are the cards, so without one it raises."""
    import torch
    from minivideo_tpu.parallel.sharding import make_mesh as jax_mesh
    from minivideo_tpu_torch.parallel.sharding import make_mesh
    with pytest.raises(ValueError, match="does not divide"):
        jax_mesh(6, 4)
    with pytest.raises(ValueError, match="does not divide"):
        _cpu_mesh(n_devices=6, seq=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("multiple", [1, 4, 8])
def test_pad_to_multiple_matches_jax(multiple):
    """Seeded arrays of 5 frames: the JAX function's padded arrays and
    real batch."""
    from minivideo_tpu.parallel.sharding import pad_to_multiple as jax_pad
    from minivideo_tpu_torch.parallel.sharding import pad_to_multiple
    rng = np.random.default_rng(7)
    arrays = {"a": rng.integers(-9, 9, (5, 3, 2)).astype(np.int16),
              "b": rng.integers(0, 255, (5,)).astype(np.uint8)}
    want, real = jax_pad(arrays, multiple)
    got, real2 = pad_to_multiple(arrays, multiple)
    assert real == real2 == 5
    for k in arrays:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("n_devices,batch", [(8, 8), (4, 16), (6, 12)])
def test_shard_packed_matches_jax_placement(n_devices, batch):
    """Shard k holds exactly the frames that the JAX shard_packed puts on
    mesh device k (its addressable shard there), and the replicated
    tables whole; a batch that is not a multiple of the mesh size gives
    the shards of its pad_to_multiple."""
    from minivideo_tpu.parallel.sharding import make_mesh as jax_mesh
    from minivideo_tpu.parallel.sharding import shard_packed as jax_shard
    from minivideo_tpu_torch.parallel.sharding import shard_packed
    rng = np.random.default_rng(batch)
    arrays = {"mb_kind": rng.integers(0, 4, (batch, 20)).astype(np.int32),
              "luma_ac": rng.integers(-50, 50, (batch, 20, 16, 16))
              .astype(np.int32)}
    ls4 = rng.integers(1, 99, (3, 6, 4, 4)).astype(np.int32)
    ls8 = rng.integers(1, 99, (6, 8, 8)).astype(np.int32)
    jmesh = jax_mesh(n_devices)
    want, (wl4, wl8) = jax_shard(jmesh, arrays, ls4, ls8)
    got = shard_packed(_cpu_mesh(n_devices), arrays, ls4, ls8)
    assert len(got) == jmesh.devices.size
    for k, dev in enumerate(jmesh.devices.flat):
        arrs, l4, l8 = got[k]
        for name, arr in want.items():
            shard, = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(arrs[name].numpy(),
                                          np.asarray(shard.data))
        np.testing.assert_array_equal(l4, np.asarray(wl4))
        np.testing.assert_array_equal(l8, np.asarray(wl8))
    # a batch 3 frames short: pad_to_multiple's zero frames, made on the
    # last shards' devices
    from minivideo_tpu_torch.parallel.sharding import pad_to_multiple
    short = {k: v[:-3] for k, v in arrays.items()}
    padded, real = pad_to_multiple(short, n_devices)
    assert real == batch - 3
    for (a, _, _), (b, _, _) in zip(
            shard_packed(_cpu_mesh(n_devices), short, ls4, ls8),
            shard_packed(_cpu_mesh(n_devices), padded, ls4, ls8)):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """5x4-MB clips as ES and MP4, a 4x3-MB MPEG-TS clip (a second
    bucket) and a 5x4-MB clip whose slice data is spoiled: 6 frames in
    the first bucket (padded to 8 over 4 entries), 2 in the second."""
    d = tmp_path_factory.mktemp("clips")
    (d / "c0.264").write_bytes(make_stream(width_mbs=5, height_mbs=4,
                                           seed=80, **KW))
    (d / "c1.mp4").write_bytes(C.write_mp4(
        make_stream(width_mbs=5, height_mbs=4, seed=81, **KW), 80, 64))
    (d / "small.ts").write_bytes(C.write_ts(
        make_stream(width_mbs=4, height_mbs=3, seed=82, **KW)))
    data = bytearray(make_stream(width_mbs=5, height_mbs=4, seed=83, **KW))
    for pos in range(len(data) * 2 // 3, len(data) - 8, 3):
        data[pos] ^= 0xFF
    (d / "bad.264").write_bytes(bytes(data))
    return sorted(str(p) for p in d.iterdir())


STAGING = {  # name -> env
    "device": {"MINIVIDEO_TPU_STAGING": "device"},
    "records": {"MINIVIDEO_TPU_STAGING": "records"},
    "raster": {"MINIVIDEO_TPU_NO_NATIVE": "1"},
}


def _run(pkg, clips, outdir, env, **kw):
    """batch_thumbnail of `pkg` under `env`, YUV420: (BatchResult, the
    bucket planes, the fused engine's calls per bucket (port only))."""
    if pkg == "jax":
        from minivideo_tpu import settings
        from minivideo_tpu.codecs import PictureFormat
        from minivideo_tpu.parallel import batch
        kw["engine"] = "fused"
    else:
        from minivideo_tpu_torch.codecs import PictureFormat
        from minivideo_tpu_torch.ops import recon_fused
        from minivideo_tpu_torch.parallel import batch
    planes, calls = [], []
    real = batch._Recon.__call__

    def recon(self, packed, **k):
        calls.append(0)
        out = real(self, packed, **k)
        planes.append([np.asarray(a) for a in out[:3]])
        return out

    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(batch._Recon, "__call__", recon)
        if pkg == "jax":     # its settings snapshot reads the env once
            mp.setattr(settings, "_settings", None)
        else:
            fused = recon_fused.reconstruct_frames_fused

            def counted(packed, device=None, **kw):
                calls[-1] += 1
                return fused(packed, device, **kw)

            mp.setattr(recon_fused, "reconstruct_frames_fused", counted)
        res = batch.batch_thumbnail(clips, outdir, pictures_per_clip=2,
                                    fmt=PictureFormat.YUV420, **kw)
    return res, planes, calls


def _files(outdir):
    names = sorted(f for f in os.listdir(outdir) if not f.endswith(".jsonl"))
    out = {}
    for n in names:
        with open(os.path.join(outdir, n), "rb") as f:
            out[n] = f.read()
    return out


@pytest.mark.parametrize("staging", list(STAGING))
def test_mesh_batch_thumbnail_matches(clips, tmp_path, staging):
    """A 2x2 mesh of CPU entries writes the bytes of the port on one CPU
    device and of the JAX package on a 4-device mesh, with the same
    bucket planes; the fused engine runs once per mesh entry and
    bucket."""
    from minivideo_tpu.parallel import make_mesh as jax_mesh
    env = STAGING[staging]
    mesh_res, mesh_planes, calls = _run(
        "port", clips, str(tmp_path / "mesh"), env, mesh=_cpu_mesh(4))
    one_res, one_planes, one_calls = _run(
        "port", clips, str(tmp_path / "one"), env, device="cpu")
    jax_res, jax_planes, _ = _run(
        "jax", clips, str(tmp_path / "jax"), env, mesh=jax_mesh(4))
    assert calls == [4, 4] and one_calls == [1, 1]
    for res in (mesh_res, one_res, jax_res):
        assert (res.done, res.failed, res.frames) == \
            (mesh_res.done, mesh_res.failed, mesh_res.frames)
    assert mesh_res.done == 3 and mesh_res.frames in (6, 8)
    files = _files(str(tmp_path / "mesh"))
    assert len(files) == 6
    assert files == _files(str(tmp_path / "one")) == \
        _files(str(tmp_path / "jax"))
    for got, one, want in zip(mesh_planes, one_planes, jax_planes):
        for a, b, c in zip(got, one, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def test_mesh_and_device_together_raise(clips, tmp_path):
    from minivideo_tpu_torch.parallel import batch_thumbnail
    with pytest.raises(ValueError, match="not both"):
        batch_thumbnail(clips, str(tmp_path), mesh=_cpu_mesh(4),
                        device="cpu")


def test_process_defaults_from_process_group(clips, tmp_path, monkeypatch):
    """With a process group initialised, process_index / process_count
    default to its rank and world size: rank 1 of 2 takes clips[1::2]
    and writes manifest.1.jsonl."""
    import torch.distributed as dist
    from minivideo_tpu_torch.parallel import Manifest, batch_thumbnail
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    res = batch_thumbnail(clips, str(tmp_path), device="cpu",
                          pictures_per_clip=2)
    with Manifest(str(tmp_path / "manifest.1.jsonl")) as man:
        assert man.pending(clips) == clips[::2]
    assert res.done + res.failed == len(clips[1::2])
    assert not os.path.exists(tmp_path / "manifest.0.jsonl")

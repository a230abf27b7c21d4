"""The port's bench (minivideo_tpu_torch/bench.py) on the CPU, at a small
size (6x4 MBs, batch 2, 3 iterations):

  * its host stage stages the bytes of bench.py's (the JAX package's
    bench at the repo root, its WMB/HMB/BATCH monkeypatched), in the
    device and the records layout, for both entropy coders;
  * host_stream hands on `iters` packs equal to host_batch's, with and
    without the staging ring;
  * the pipeline (`--device cpu`: the kernel's plain version on unpinned
    staging) gives the JAX package's pictures for every batch;
  * a ring set reused after a slice that failed half way reads like a
    fresh set: in the records mode once cleared, in the device mode with
    no clear, the MBs that a cut slice left unwritten zeroed at the pack
    and counted;
  * a corrupted plane fails the output check (exit code 1), a batch that
    differs fails the checked run;
  * the trace reader's counts of a hand-written Chrome trace;
  * without a card and without `--device cpu` the bench raises;
  * tests/test_torch_gpu_bench.py's pinned digests are the JAX
    package's.
torch and the port are imported inside the tests (see
torch_port_helpers.py).
"""

import hashlib
import importlib.util
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--size", "96x64", "--batch", "2", "--iters",
         "3", "--runs", "1"]
KW = dict(width_mbs=6, height_mbs=4, n_pictures=3, seed=81, n_slices=2,
          mb_kinds=("i16", "i4", "i8"), transform_8x8=True, allow_pcm=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these loops of small torch ops run faster on
    one, and the suite's parallel workers share the host's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench(tmp_path, monkeypatch):
    from minivideo_tpu_torch import bench as mod
    monkeypatch.setattr(mod, "CACHE", str(tmp_path / "cache"))
    return mod


@pytest.fixture
def pool():
    with ThreadPoolExecutor(max_workers=4) as p:
        yield p


def _stream(entropy, **kw):
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    return make_stream2(entropy=entropy, **dict(KW, **kw))


def _root_bench(monkeypatch, wmb, hmb, batch):
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    monkeypatch.setattr(root, "WMB", wmb)
    monkeypatch.setattr(root, "HMB", hmb)
    monkeypatch.setattr(root, "BATCH", batch)
    return root


def _laid_out(pk):
    """A device-mode pack's records through the plain gather: the four
    feeds of the JAX package's device layout, as numpy arrays."""
    import torch
    from minivideo_tpu_torch.ops.recon_fused import DEVICE_STAGING
    from minivideo_tpu_torch.ops.wave_layout import wave_layout_plain
    feeds = wave_layout_plain(torch.from_numpy(pk.arrays["records"]),
                              pk.wmb, pk.hmb)
    return {k: f.numpy() for k, f in zip(DEVICE_STAGING, feeds)}


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("mode,entropy", [("device", "cavlc"),
                                          ("device", "cabac"),
                                          ("records", "cavlc"),
                                          ("records", "cabac")])
def test_host_batch_stages_root_bench_bytes(bench, pool, monkeypatch, mode,
                                            entropy):
    """Two slices a picture.  bench.py packs slice id 0 for every MB of
    the records layout; the port packs each MB's slice, as the JAX
    package's decoder does (its slice_of_mb).  The device mode's records,
    laid out by the plain gather, are bench.py's feeds."""
    from torch_port_helpers import jax_packed
    data = _stream(entropy)
    root = _root_bench(monkeypatch, KW["width_mbs"], KW["height_mbs"], 4)
    want = root.host_batch(*root.prep_pictures(data), pool, mode)
    got = bench.host_batch(*bench.prep_pictures(data), pool, mode, 4)
    if mode == "records":
        ids = jax_packed(data, "records")[0].arrays["slice_id"]
        assert (ids == 1).any() and not (want.arrays["slice_id"]).any()
        want.arrays["slice_id"] = ids[np.arange(4) % 3]
    assert (got.slots, got.has8x8, got.haspcm) == (want.slots, want.has8x8,
                                                   want.haspcm)
    assert got.chroma_qp_off == tuple(want.chroma_qp_off)
    np.testing.assert_array_equal(got.ls4, want.ls4)
    np.testing.assert_array_equal(got.ls8, want.ls8)
    _same_arrays(_laid_out(got) if mode == "device" else got.arrays,
                 want.arrays)


@pytest.mark.parametrize("ring", [False, True])
def test_host_stream_hands_on_host_batch_packs(bench, pool, ring):
    import torch
    prep = bench.prep_pictures(_stream("cabac"))
    want = bench.host_batch(*prep, pool, "device", 2)
    r = (bench.StagingRing("device", KW["width_mbs"], KW["height_mbs"], 2,
                           torch.device("cpu")) if ring else None)
    seen = []

    def consume(pk, slot):
        _same_arrays(pk.arrays, want.arrays)
        seen.append(slot)
        if slot is not None:
            r.release(slot)

    bench.host_stream(*prep, pool, "device", 3, 2, consume=consume, ring=r)
    assert len(seen) == 3
    if ring:
        # no set is cleared: clear_s times each batch's zero_uncovered
        assert seen[0] is seen[2] is not seen[1]
        assert len(r.clear_s) == 3 and r.zeroed_records == 0


@pytest.mark.parametrize("mode", ["device", "records"])
def test_cpu_pipeline_gives_jax_pictures(bench, monkeypatch, mode):
    import torch
    from minivideo_tpu.models.h264.decoder import decode_annexb
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", mode)
    data = _stream("cavlc")
    want = decode_annexb(data, engine="np")
    b = bench.Bench(torch.device("cpu"), KW["width_mbs"], KW["height_mbs"],
                    2, 3, 1)
    got = []
    try:
        assert b.mode == mode
        b.overlapped(bench.prep_pictures(data),
                     lambda i, planes: got.append([p.copy()
                                                   for p in planes]))
    finally:
        b.close()
    assert len(got) == 3
    for i, planes in enumerate(got):
        for row in range(2):
            p = want[row % 3]
            for name, a, w in zip(("Y", "Cb", "Cr"), planes,
                                  (p.y, p.cb, p.cr)):
                np.testing.assert_array_equal(a[row], w,
                                              err_msg=f"batch {i} {name}")


@pytest.mark.parametrize("mode", ["device", "records"])
def test_reused_ring_set_after_bad_slice_is_fresh(bench, pool, mode):
    """A slice cut short fails half way, leaving its first MBs written,
    beside a whole picture.  The next batch holds, where that whole
    picture lay, a picture whose one slice, cut elsewhere, parses
    without error but leaves its last 16 MBs unwritten.  The records mode
    clears the set before that batch; the device mode clears nothing, its
    pack zeroes the unwritten MBs' records, counts them and times that
    once.  Either way the batch's staging equals a fresh set's, byte for
    byte."""
    import torch
    from minivideo_tpu_torch.bitio import BitstreamError
    from minivideo_tpu_torch.testing.streams import cut_idr
    bad = cut_idr(_stream("cavlc", n_slices=1), picks=(1,), keep=0.5)
    short = cut_idr(_stream("cavlc", n_slices=1, seed=82), picks=(0,),
                    keep=0.46)
    r = bench.StagingRing(mode, KW["width_mbs"], KW["height_mbs"], 2,
                          torch.device("cpu"))
    slot = r.acquire()
    with pytest.raises(BitstreamError):
        bench.host_batch(*bench.prep_pictures(bad), pool, mode, 2,
                         staging=slot.staging)
    assert any(a.any() for a in slot.host.values())    # half written
    r.release(slot)
    r.release(r.acquire())                      # the ring's other set
    again = r.acquire()
    assert again is slot
    assert len(r.clear_s) == (0 if mode == "device" else 1)
    prep = bench.prep_pictures(short)
    staging, frames, tasks = bench.make_batch(*prep, mode, 2, again.staging)
    list(pool.map(bench.parse_slice_task, tasks))
    unwritten = frames[0][1] < 0
    assert unwritten.sum() == 16 and not (frames[1][1] < 0).any()
    if mode == "device":                        # stale bytes lie there
        assert staging["records"][0][unwritten].any()
    got = bench.pack_batch(staging, frames, *prep[1:], mode, r)
    want = bench.host_batch(*prep, pool, mode, 2)
    _same_arrays(got.arrays, want.arrays)
    assert len(r.clear_s) == 1
    assert r.zeroed_records == (16 if mode == "device" else 0)


def test_corrupted_plane_exits_nonzero(bench, monkeypatch, capsys):
    oracle = bench.oracle_planes

    def corrupted(data):
        y, cb, cr = oracle(data)
        cr = cr.copy()
        cr[3, 5] ^= 1
        return y, cb, cr

    monkeypatch.setattr(bench, "oracle_planes", corrupted)
    with pytest.raises(SystemExit) as e:
        bench.main(SMALL)
    assert e.value.code == 1
    out = capsys.readouterr()
    assert out.out == "" and "Cr plane" in out.err


def test_checked_run_catches_a_differing_batch(bench, monkeypatch):
    import torch
    data = _stream("cavlc")
    prep = bench.prep_pictures(data)
    b = bench.Bench(torch.device("cpu"), KW["width_mbs"], KW["height_mbs"],
                    2, 3, 1)
    recon, calls = b.recon, []

    def spoiled(pk, arrays):
        planes = recon(pk, arrays)
        calls.append(1)
        if len(calls) == 3:
            planes[0][1, 7, 9] ^= 4
        return planes

    try:
        oracle = bench.oracle_planes(data)
        b.checked_run(prep, oracle, "cavlc")            # unspoiled
        monkeypatch.setattr(b, "recon", spoiled)
        with pytest.raises(bench.CheckFailed, match="batch 2 differs"):
            b.checked_run(prep, oracle, "cavlc")
    finally:
        b.close()


def test_read_trace_counts_a_hand_written_trace(bench, tmp_path):
    events = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1,
         "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "wave_kernel_cuda",
         "ts": 90, "dur": 8},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 92, "dur": 3},
        {"ph": "X", "cat": "user_annotation", "name": "wave_kernel_cuda",
         "ts": 400, "dur": 8},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 403, "dur": 3},
        {"ph": "X", "cat": "user_annotation", "name": "wave_kernel_cuda",
         "ts": 800, "dur": 8},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 1, "dur": 2},
        {"ph": "X", "cat": "kernel", "ts": 100, "dur": 200,
         "name": "(anonymous namespace)::wave_kernel("
                 "(anonymous namespace)::Args)"},
        {"ph": "X", "cat": "kernel", "ts": 250, "dur": 100,
         "name": "void at::native::vectorized_elementwise_kernel<4>()"},
        {"ph": "X", "cat": "kernel", "ts": 600, "dur": 100,
         "name": "(anonymous namespace)::wave_kernel("
                 "(anonymous namespace)::Args)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 0, "dur": 50,
         "name": "Memcpy HtoD (Pinned -> Device)", "args": {"bytes": 4096}},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 20, "dur": 60,
         "name": "Memcpy HtoD (Pinned -> Device)", "args": {"bytes": 1000}},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 950, "dur": 100,
         "name": "Memcpy DtoH (Device -> Pinned)", "args": {"bytes": 77}},
        {"ph": "X", "cat": "gpu_memset", "ts": 500, "dur": 10,
         "name": "Memset (Device)"},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 5, "id": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = bench.read_trace(str(path))
    # the third annotation launched nothing (a refused launch)
    assert t["wave_kernel_launches"] == 2 and t["memcpy_calls"] == 1
    assert t["wave_kernel"] == 2 and t["other_kernels"] == 1
    assert t["h2d"] == {"count": 2, "bytes": 5096}
    assert t["d2h"] == {"count": 1, "bytes": 77}
    assert t["d2d"] == {"count": 0, "bytes": 0}
    # busy: [0, 80) + [100, 350) + [500, 510) + [600, 700) + [950, 1000)
    assert t["window_ms"] == pytest.approx(1.0)
    assert t["busy_ms"] == pytest.approx(0.49)
    assert t["busy_share"] == pytest.approx(0.49)


def test_bench_raises_without_a_card(bench, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(SMALL[2:])
    with pytest.raises(SystemExit):
        bench.parse_args(["--size", "100x64"])


def test_main_prints_one_json_line(bench, capsys):
    bench.main(SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    r = json.loads(out[0])
    assert r["transfer_included"] is True and r["output_check"] == "bit-exact"
    assert r["checked_runs"] == 4 and r["card"] is None
    assert r["device"] == "cpu" and r["size"] == "96x64"
    assert r["stream"] in ("x264", "synthetic")
    assert r["value"] == r["value_cavlc"] > 0
    for k in ("value_cabac", "device_fps", "device_fps_records_staging",
              "entropy_cavlc_fps", "entropy_cabac_fps"):
        assert r[k] > 0, k
    assert set(r["high_profile_8x8"]["e2e_median"]) == {"cavlc", "cabac"}
    assert r["thumbnails_per_s"]["jpg_median"] > 0
    assert r["slice_parallel"]["slices"] == 4
    assert r["ring"]["clears"] > 0


def test_synthetic_streams_without_libavcodec(bench, monkeypatch):
    """Where tools/x264_fixture.c does not build, the streams come from
    make_stream2 with the variant's 4 slices and 8x8 transform."""
    from minivideo_tpu_torch.testing import x264

    def no_libav():
        raise RuntimeError("no libavcodec")

    monkeypatch.setattr(x264, "encoder", no_libav)
    streams, source = bench.get_streams(["cavlc_8x8", "cabac_s4"], 64, 48)
    assert source == "synthetic"
    assert streams == bench.get_streams(["cavlc_8x8", "cabac_s4"], 64,
                                        48)[0]                   # cached
    pics, _, pps = bench.prep_pictures(streams["cavlc_8x8"])
    assert len(pics) == 2 and pps.transform_8x8_mode_flag
    pics, _, pps = bench.prep_pictures(streams["cabac_s4"])
    assert [len(p) for p in pics] == [4, 4]
    assert pps.entropy_coding_mode_flag


def test_gpu_pipeline_digests_are_the_jax_package_s():
    from fixtures.h264enc import make_stream
    from minivideo_tpu.models.h264.decoder import decode_annexb
    from test_torch_gpu_bench import PIPE_DIGESTS, PIPE_KW
    pics = decode_annexb(make_stream(**PIPE_KW), engine="np")
    assert [[hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
             for a in (p.y, p.cb, p.cr)] for p in pics] == PIPE_DIGESTS

"""bench.py's own libx264 workload in the port's bench
(minivideo_tpu_torch/bench.py): the five 1080p streams committed under
minivideo_tpu_torch/testing/ (testing/streams.BENCH_X264), on the CPU:

  * each stream's SHA-256 is its pin, and its pinned encoder arguments
    are bench.py's (the JAX package's bench at the repo root);
  * the CAVLC and CABAC bits a picture are BENCH_r05.json's, the TPU
    run of bench.py on these streams;
  * where tools/x264_fixture.c builds, re-encoding gives the committed
    bytes; where tools/h264_lavc_decode.c builds, libavcodec's picture
    digests are the pins;
  * get_streams at 1920x1088 reads the committed files without the
    encoder and writes no cache; a missing or altered file raises;
  * the bench's libavcodec checks: one 1080p picture of the 4-slice
    stream through the host stage and the kernel's plain version equals
    its digest, and a checked run holds every picture of its first
    batch to the digests and fails on a wrong one.
torch and the port are imported inside the tests (see
torch_port_helpers.py).
"""

import importlib.util
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["cavlc", "cabac", "cavlc_8x8", "cabac_8x8", "cabac_s4"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the
    host's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tools():
    from minivideo_tpu_torch.testing import x264
    return x264


def _built(tool):
    try:
        return tool()
    except RuntimeError as e:
        pytest.skip(f"libx264/libavcodec tools unavailable: {e}")


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    return root


@pytest.mark.parametrize("name", NAMES)
def test_committed_stream_is_pinned_with_bench_py_arguments(name):
    import hashlib
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.testing import streams as st
    fname, args, sha, digests = st.BENCH_X264[name]
    data = st.bench_x264(name)
    assert hashlib.sha256(data).hexdigest() == sha
    assert fname == f"bench_x264_1080p_{name}.264" and len(digests) == 8
    root = _root_bench()
    entropy, slices, dct8 = bench.STREAMS[name]
    assert args == (16 * root.WMB, 16 * root.HMB, root.N_FRAMES, root.QP,
                    int(entropy == "cabac"), int(dct8), 42, slices,
                    root.NOISE)
    assert args == (*bench.SIZE, bench.N_FRAMES, bench.QP,
                    int(entropy == "cabac"), int(dct8), bench.SEED, slices,
                    bench.NOISE)


def test_bits_per_picture_are_bench_r05_s():
    """BENCH_r05.json's tail ends with bench.py's JSON line."""
    from minivideo_tpu_torch.testing import streams as st
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    line = [x for x in tail.splitlines() if x.startswith("{")][-1]
    r05 = json.loads(line)
    assert r05["stream"] == "x264" and r05["distinct_frames"] == 8
    for e in ("cavlc", "cabac"):
        frames = st.BENCH_X264[e][1][2]
        assert (len(st.bench_x264(e)) * 8 // frames
                == r05[f"bits_per_frame_{e}"]), e
    assert r05["bits_per_frame_cavlc"] == 2309953
    assert r05["bits_per_frame_cabac"] == 1874036


@pytest.mark.parametrize("name", NAMES)
def test_reencoding_gives_the_committed_bytes(tools, name):
    from minivideo_tpu_torch.testing import streams as st
    _built(tools.encoder)
    _, args, _, _ = st.BENCH_X264[name]
    assert tools.x264_stream(*args) == st.bench_x264(name)


@pytest.mark.parametrize("name", NAMES)
def test_libavcodec_digests_are_the_pins(tools, name):
    from minivideo_tpu_torch.testing import streams as st
    _built(tools.decoder)
    pics = tools.lavc_decode(st.bench_x264(name))
    assert [p[0].shape for p in pics] == [(1088, 1920)] * 8
    assert [st.picture_sha256(*p) for p in pics] == st.BENCH_X264[name][3]


def test_get_streams_reads_the_committed_files_at_1080p(tmp_path,
                                                       monkeypatch):
    """No encoder, no cache, no fallback: a missing or altered file
    raises."""
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.testing import streams as st
    from minivideo_tpu_torch.testing import x264

    def no_libav():
        raise RuntimeError("no libavcodec")

    cache = tmp_path / "cache"
    monkeypatch.setattr(bench, "CACHE", str(cache))
    monkeypatch.setattr(x264, "encoder", no_libav)
    streams, source = bench.get_streams(NAMES, 1920, 1088)
    assert source == "x264" and not cache.exists()
    assert streams == {n: st.bench_x264(n) for n in NAMES}
    assert bench.lavc_digests(["cabac_s4"], 1920, 1088) == {
        "cabac_s4": st.BENCH_X264["cabac_s4"][3]}
    assert bench.lavc_digests(["cabac_s4"], 64, 48) == {}

    copy = tmp_path / "testing"
    copy.mkdir()
    for n in NAMES:
        shutil.copy(os.path.join(st.HERE, st.BENCH_X264[n][0]), copy)
    monkeypatch.setattr(st, "HERE", str(copy))
    assert bench.get_streams(["cabac"], 1920, 1088)[0]["cabac"] == \
        streams["cabac"]
    path = copy / st.BENCH_X264["cabac"][0]
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="SHA-256"):
        bench.get_streams(["cavlc", "cabac"], 1920, 1088)
    path.unlink()
    with pytest.raises(RuntimeError, match="missing"):
        bench.get_streams(["cabac"], 1920, 1088)
    assert not cache.exists()


def test_the_bench_holds_pictures_to_libavcodec():
    """Picture 0 of the 4-slice 1080p stream through host_batch in the
    records layout (each MB's slice id) and the kernel's plain version;
    then a small checked run (3 distinct pictures, batch 2) with the
    JAX package's pictures as the digests, and with one digest wrong."""
    import torch
    from minivideo_tpu.models.h264.decoder import decode_annexb
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.testing import streams as st
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    pictures, sps, pps = bench.prep_pictures(st.bench_x264("cabac_s4"))
    assert [len(p) for p in pictures] == [4] * 8
    b = bench.Bench(torch.device("cpu"), 120, 68, 1, 1, 1)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            pk = bench.host_batch(pictures[:1], sps, pps, pool, "records", 1)
        planes = b.recon(pk, {k: torch.from_numpy(a)
                              for k, a in pk.arrays.items()})
        bench.lavc_check([[p[0].numpy() for p in planes]],
                         st.BENCH_X264["cabac_s4"][3], "cabac_s4")
    finally:
        b.close()

    data = make_stream2(width_mbs=6, height_mbs=4, n_pictures=3, seed=81,
                        n_slices=2, entropy="cabac")
    digests = [st.picture_sha256(p.y, p.cb, p.cr)
               for p in decode_annexb(data, engine="np")]
    prep = bench.prep_pictures(data)
    b = bench.Bench(torch.device("cpu"), 6, 4, 2, 3, 1)
    try:
        oracle = bench.oracle_planes(data)
        assert b.checked_run(prep, oracle, "cabac", digests) == 2
        assert b.checked_run(prep, oracle, "cabac") == 0
        wrong = digests[:1] + digests[:1] + digests[2:]
        with pytest.raises(bench.CheckFailed,
                           match="batch 0 picture 1 differs from "
                                 "libavcodec's"):
            b.checked_run(prep, oracle, "cabac", wrong)
    finally:
        b.close()

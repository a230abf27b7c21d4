"""The port's halo engine (minivideo_tpu_torch/parallel/halo.py) against
the JAX package's (minivideo_tpu/parallel/halo.py), on the CPU, with
tolerance 0: one frame's fused lane axis split into strips over a mesh
of CPU entries, one edge lane of boundary state exchanged per wave,
held against the JAX reconstruct_frames_halo on the same number of CPU
devices (shard_map with ppermute halos) and against the numpy oracle
recon_np.  The streams mirror tests/test_halo.py.  (The port is imported
inside the tests: see torch_port_helpers.py.)"""

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from torch_port_helpers import assert_planes_equal, jax_staging

HALO_STREAMS = {
    # wmb=5, hmb=4 -> maxw=4; batch 1 -> 4 lanes over 4 strips: every
    # macroblock's left/top state crosses a strip boundary
    "single_frame_4": (dict(width_mbs=5, height_mbs=4, n_pictures=1,
                            seed=33, mb_kinds=("i16", "i4"), density=0.4,
                            allow_pcm=False), 4),
    # maxw=4, batch 2 -> L=8 lanes over 8 strips; the frame-segment
    # boundary sits exactly on a strip boundary
    "two_frames_8": (dict(width_mbs=6, height_mbs=5, n_pictures=2, seed=60,
                          mb_kinds=("i16", "i4"), density=0.35,
                          allow_pcm=True), 8),
    # wider geometry: maxw=6, batch 2 -> L=12 over 4 strips
    "wide_4": (dict(width_mbs=10, height_mbs=6, n_pictures=2, seed=61,
                    mb_kinds=("i16", "i4"), density=0.35,
                    allow_pcm=False), 4),
}
SLOT_KW = dict(width_mbs=5, height_mbs=4, n_pictures=2, seed=35,
               mb_kinds=("i16", "i4"), density=0.4, allow_pcm=False)


def _port_mesh(n, axis="lanes"):
    from minivideo_tpu_torch.parallel.sharding import Mesh
    devs = np.empty(n, dtype=object)
    devs[:] = ["cpu"] * n
    return Mesh(devs, (axis,))


def _jax_halo(packed, n):
    import jax
    from jax.sharding import Mesh
    from minivideo_tpu.parallel.halo import reconstruct_frames_halo
    mesh = Mesh(np.array(jax.devices()[:n]), ("lanes",))
    return [np.asarray(a) for a in reconstruct_frames_halo(packed, mesh)]


def _port_halo(packed, n):
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.parallel.halo import reconstruct_frames_halo
    out = reconstruct_frames_halo(packed_from_numpy(packed, "cpu"),
                                  _port_mesh(n))
    return [a.numpy() for a in out]


def _oracle(data):
    """recon_np's planes of every picture of `data`, [B, H, W] each."""
    from minivideo_tpu.models.h264.recon_np import reconstruct_frame
    from tests.test_recon_jax import _parse_stream
    frames, sps, pps = _parse_stream(data)
    pics = [reconstruct_frame(fs, sps, pps, som) for fs, som in frames]
    return [np.stack([p[i] for p in pics]) for i in range(3)]


@pytest.mark.parametrize("name", list(HALO_STREAMS))
def test_halo_matches_jax_and_oracle(name):
    """Raster staging over 4 or 8 CPU strips: the JAX halo's planes and
    recon_np's."""
    kw, n = HALO_STREAMS[name]
    data = make_stream(**kw)
    packed = jax_staging(data, "raster")
    got = _port_halo(packed, n)
    assert_planes_equal(_jax_halo(packed, n), got, f"{name} jax")
    assert_planes_equal(_oracle(data), got, f"{name} oracle")


def test_halo_slot_staging():
    """The native parser's slot records (records staging) through the
    halo over 4 strips, as the JAX test_halo_slot_staging."""
    data = make_stream(**SLOT_KW)
    packed = jax_staging(data, "records")
    got = _port_halo(packed, 4)
    assert_planes_equal(_jax_halo(packed, 4), got, "slots jax")
    assert_planes_equal(_oracle(data), got, "slots oracle")


def test_halo_device_layout():
    """The device layout (the kernel's staging, no JAX halo takes it)
    over 4 strips: the oracle's planes, and the port's fused engine's."""
    import torch
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops.recon_fused import reconstruct_frames_fused
    data = make_stream(**SLOT_KW)
    packed = jax_staging(data, "device")
    got = _port_halo(packed, 4)
    assert_planes_equal(_oracle(data), got, "device oracle")
    want = reconstruct_frames_fused(packed_from_numpy(packed, "cpu"), "cpu")
    assert all(torch.equal(torch.as_tensor(g), w) for g, w in zip(got, want))


def test_make_reconstruct_halo_entry_points():
    """make_reconstruct_halo's (recon, recon_slots) over raster and slot
    tensors equal reconstruct_frames_halo's planes, from a 2-D mesh whose
    "seq" axis carries the strips."""
    import torch
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.parallel.halo import (make_reconstruct_halo,
                                                   reconstruct_frames_halo)
    from minivideo_tpu_torch.parallel.sharding import make_mesh
    data = make_stream(**SLOT_KW)
    mesh = make_mesh(devices=["cpu"] * 8, seq=4)     # data 2 x seq 4
    want = _oracle(data)
    for layout in ("raster", "records"):
        p = packed_from_numpy(jax_staging(data, layout), "cpu")
        recon, recon_slots = make_reconstruct_halo(p.wmb, p.hmb, p.batch,
                                                   mesh, axis="seq")
        if layout == "raster":
            out = recon(p.arrays, p.ls4, p.ls8, *p.chroma_qp_off)
        else:
            small = {k: v for k, v in p.arrays.items()
                     if not k.endswith("_slab")}
            out = recon_slots(small, p.arrays["luma_slab"],
                              p.arrays["chroma_slab"], p.arrays["dc_slab"],
                              p.ls4, p.ls8, *p.chroma_qp_off)
        assert_planes_equal(want, [a.numpy() for a in out], layout)
        again = reconstruct_frames_halo(p, mesh, axis="seq")
        assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_non_dividing_lane_count_raises():
    """5x4 MBs, one frame: 4 lanes do not split over 3 strips, in either
    package."""
    import jax
    from jax.sharding import Mesh
    from minivideo_tpu.parallel.halo import make_reconstruct_halo as jax_make
    from minivideo_tpu_torch.parallel.halo import make_reconstruct_halo
    with pytest.raises(AssertionError, match="must divide"):
        jax_make(5, 4, 1, Mesh(np.array(jax.devices()[:3]), ("lanes",)))
    with pytest.raises(ValueError, match="must divide"):
        make_reconstruct_halo(5, 4, 1, _port_mesh(3))


def test_halo_loop_exchange_across_callers():
    """halo_loop's strips split between two lockstep callers, as two
    processes run them: each fills its own rows of the edge buffer and
    an exchange completes them with the other's (here two threads and a
    barrier-summed buffer stand in for the all_reduce).  The two
    callers' lanes together give the oracle's planes."""
    import threading
    import torch
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops.recon_fused import raster_feeds, unskew_fused
    from minivideo_tpu_torch.ops.recon_wave import skew_tables
    from minivideo_tpu_torch.parallel.halo import halo_loop, lane_feeds
    data = make_stream(**SLOT_KW)
    p = packed_from_numpy(jax_staging(data, "raster"), "cpu")
    g = skew_tables(p.wmb, p.hmb)
    g["wmb"], g["hmb"] = p.wmb, p.hmb
    feeds = lane_feeds(raster_feeds(p.arrays, *p.chroma_qp_off, p.wmb,
                                    p.hmb, p.batch))
    cpu = [torch.device("cpu")] * 2
    bufs, total, outs = [None, None], [None], [None, None]
    barrier = threading.Barrier(2)

    def run(k):
        def exchange(buf):
            bufs[k] = buf
            if barrier.wait() == 0:
                total[0] = bufs[0] + bufs[1]
            barrier.wait()
            return total[0].clone()

        outs[k] = halo_loop(feeds, p.ls4, p.ls8, g, p.batch, cpu,
                            first=2 * k, n_strips=4, exchange=exchange)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out_y = torch.cat([outs[0][0], outs[1][0]], 2)
    out_c = torch.cat([outs[0][1], outs[1][1]], 2)
    got = unskew_fused(out_y, out_c, g, p.batch)
    assert_planes_equal(_oracle(data), [a.numpy() for a in got], "split")
    with pytest.raises(ValueError, match="exchange"):
        halo_loop(feeds, p.ls4, p.ls8, g, p.batch, cpu, first=2,
                  n_strips=4)

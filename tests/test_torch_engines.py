"""The port's batched engines' building blocks against the JAX package's,
on the CPU, with tolerance 0: the transforms (ops/transform.py),
build_residuals and the zero-copy raster staging (ops/recon.py), the wave
engine (ops/recon_wave.reconstruct_frames_wave, which runs the lane loop)
against the JAX wave loop, the lane loop
(ops/recon_lane.reconstruct_frames_lane) against the JAX lane loop, and
the integer taps that stand in for the JAX package's selection-matrix
matmuls.

Every stream of the wave and lane tests has the same geometry (6x4 MBs)
and batch (2 pictures), so the JAX wave and lane loops compile once per
module: kinds I16x16/I4x4/I8x8 with I_PCM, three slices, QP 0 and 51,
custom scaling lists, and a CABAC stream.  (torch and the port are imported inside the
tests: see torch_port_helpers.py.)"""

import functools

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from torch_port_helpers import assert_planes_equal, jax_staging

KINDS = ("i16", "i4", "i8")
STREAMS = {
    "kinds_pcm": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=21, profile=100,
        transform_8x8=True, mb_kinds=KINDS, allow_pcm=True, density=0.5),
    "slices": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=22, profile=100,
        transform_8x8=True, mb_kinds=KINDS, n_slices=3),
    "qp0": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=23, qp=0,
        mb_kinds=("i16", "i4"), allow_pcm=True),
    "qp51": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=24, qp=51,
        profile=100, transform_8x8=True, mb_kinds=KINDS),
    "lists": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=2, seed=25, profile=100,
        transform_8x8=True, mb_kinds=("i8", "i4"),
        scaling_lists=[(1, None)] * 8,
        pps_scaling_lists=[(1, list(range(8, 24)))] * 6
        + [(1, list(range(6, 70)))] * 2),
    "cabac": lambda: make_stream2(
        6, 4, 2, 26, entropy="cabac", mb_kinds=KINDS, transform_8x8=True,
        allow_pcm=True, n_slices=2, density=0.5),
}


@functools.lru_cache(maxsize=None)
def _raster(name):
    """The JAX package's raster PackedFrames of STREAMS[name]."""
    return jax_staging(STREAMS[name](), "raster")


def _port(packed):
    from minivideo_tpu_torch.convert import packed_from_numpy
    return packed_from_numpy(packed, "cpu")


def _numpy(planes):
    return [np.asarray(p) for p in planes]


# ---------------------------------------------------------------------------
# transforms


@pytest.mark.parametrize("qp", [0, 10, 26, 36, 47, 51])
def test_transforms_match_jax(qp):
    """dequant_4x4/8x8, the luma and chroma DC transforms and the 4x4/8x8
    IDCTs (with their components-first internals) on random levels, a
    random custom scaling list, and qp plus a spread of qps around it."""
    import jax.numpy as jnp
    import torch
    from minivideo_tpu.ops import transform as J
    from minivideo_tpu_torch.ops import transform as T
    rng = np.random.default_rng(qp)
    lists = rng.integers(1, 256, 16), rng.integers(1, 256, 64)
    ls4 = J.level_scale_4x4_np(lists[0])
    ls8 = J.level_scale_8x8_np(lists[1])
    np.testing.assert_array_equal(T.level_scale_4x4_np(lists[0]), ls4)
    np.testing.assert_array_equal(T.level_scale_8x8_np(lists[1]), ls8)
    N = 300
    qps = np.clip(qp + rng.integers(-3, 4, N), 0, 51).astype(np.int32)
    qps[:N // 2] = qp
    c4 = rng.integers(-2048, 2048, (N, 4, 4)).astype(np.int32)
    c8 = rng.integers(-2048, 2048, (N, 8, 8)).astype(np.int32)
    c2 = rng.integers(-2048, 2048, (N, 2, 2)).astype(np.int32)
    t = torch.as_tensor
    cases = [
        (J.dequant_4x4(jnp.asarray(c4), jnp.asarray(qps), jnp.asarray(ls4)),
         T.dequant_4x4(t(c4), t(qps), t(ls4))),
        (J.dequant_8x8(jnp.asarray(c8), jnp.asarray(qps), jnp.asarray(ls8)),
         T.dequant_8x8(t(c8), t(qps), t(ls8))),
        (J.luma_dc_transform(jnp.asarray(c4), jnp.asarray(qps),
                             jnp.asarray(ls4)),
         T.luma_dc_transform(t(c4), t(qps), t(ls4))),
        (J.chroma_dc_transform(jnp.asarray(c2), jnp.asarray(qps),
                               jnp.asarray(ls4)),
         T.chroma_dc_transform(t(c2), t(qps), t(ls4))),
        (J.idct_4x4(jnp.asarray(c4 * 8)), T.idct_4x4(t(c4 * 8))),
        (J.idct_8x8(jnp.asarray(c8 * 8)), T.idct_8x8(t(c8 * 8))),
        # a scalar qp broadcasts over the blocks
        (J.dequant_4x4(jnp.asarray(c4), jnp.asarray(qp), jnp.asarray(ls4)),
         T.dequant_4x4(t(c4), qp, t(ls4))),
    ]
    for i, (want, got) in enumerate(cases):
        assert got.dtype == torch.int32, i
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=f"case {i}")


# ---------------------------------------------------------------------------
# residuals and staging


@pytest.mark.parametrize("name", ["kinds_pcm", "lists"])
def test_build_residuals_match_jax(name):
    """r4, r8, the I16x16/PCM luma residual and the chroma residual of a
    raster batch: 8x8 blocks and I_PCM samples, or custom scaling
    lists."""
    import jax.numpy as jnp
    from minivideo_tpu.ops.recon import build_residuals as j_build
    from minivideo_tpu_torch.ops.recon import build_residuals
    pk = _raster(name)
    want = j_build({k: jnp.asarray(v) for k, v in pk.arrays.items()},
                   jnp.asarray(pk.ls4), jnp.asarray(pk.ls8),
                   *pk.chroma_qp_off)
    tp = _port(pk)
    got = build_residuals(tp.arrays, tp.ls4, tp.ls8, *tp.chroma_qp_off)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_frame_staging_matches_jax(entropy):
    """make_frame_staging / syntax_into / pack_frames_staged: the native
    parser writes straight into the staging buffers, and the packed batch
    equals the JAX package's staged pack (and the port's copying
    pack_frames); the wave engine decodes it to the JAX package's
    pictures."""
    from minivideo_tpu.models.h264.decoder import H264Decoder as JDec
    from minivideo_tpu.models.h264.recon_np import reconstruct_frame
    from minivideo_tpu.native import parse_slice_native as j_parse
    from minivideo_tpu.ops import recon as J
    from minivideo_tpu_torch.models.h264.decoder import H264Decoder
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    from minivideo_tpu_torch.models.h264.slicehdr import parse_slice_header
    from minivideo_tpu_torch.native import parse_slice_native
    from minivideo_tpu_torch.ops import recon as T
    from minivideo_tpu_torch.ops.recon_wave import reconstruct_frames_wave
    wmb, hmb, npic = 6, 5, 3
    data = make_stream2(wmb, hmb, npic, 91, entropy=entropy,
                        mb_kinds=("i16", "i4"), density=0.4)
    out = {}
    for pkg, dec, parse, R in (
            ("port", H264Decoder(device="cpu"), parse_slice_native, T),
            ("jax", JDec(), j_parse, J)):
        nalus = [parse_nalu(raw, off) for off, raw in split_annexb(data)]
        for n in nalus:
            if n.nal_unit_type in (7, 8):
                dec.feed_nalu(n)
        idrs = [n for n in nalus if n.nal_unit_type == 5]
        staging = R.make_frame_staging(wmb, hmb, npic)
        frames = []
        for i, nalu in enumerate(idrs):
            fs = R.syntax_into(staging, i, wmb, hmb)
            sh, sps, pps = parse_slice_header(
                nalu.rbsp, nalu.nal_unit_type, nalu.nal_ref_idc,
                dec.sps_map, dec.pps_map)
            parse(fs, nalu.rbsp, sh.data_bit_offset, sh.first_mb_in_slice,
                  sh.qp, bool(pps.entropy_coding_mode_flag),
                  bool(pps.transform_8x8_mode_flag))
            frames.append((fs, None))
        out[pkg] = (R.pack_frames_staged(staging, frames, sps, pps),
                    R.pack_frames(frames, sps, pps), frames, sps, pps)
    a, a_copy = out["port"][:2]
    b, _, frames, sps, pps = out["jax"]
    assert set(a.arrays) == set(b.arrays) == set(a_copy.arrays)
    for k in b.arrays:
        np.testing.assert_array_equal(a.arrays[k], np.asarray(b.arrays[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(a.arrays[k], a_copy.arrays[k],
                                      err_msg=k)
    assert a.arrays["luma_ac"].base is not None       # the staging itself
    np.testing.assert_array_equal(a.ls4, b.ls4)
    np.testing.assert_array_equal(a.ls8, b.ls8)
    assert a.chroma_qp_off == b.chroma_qp_off and a.slots == 0
    np.testing.assert_array_equal(T.wave_tables(wmb, hmb)[0],
                                  J.wave_tables(wmb, hmb)[0])
    np.testing.assert_array_equal(T.wave_tables(wmb, hmb)[1],
                                  J.wave_tables(wmb, hmb)[1])
    got = _numpy(reconstruct_frames_wave(a, "cpu"))
    for i, (fs, _) in enumerate(frames):
        assert_planes_equal(reconstruct_frame(fs, sps, pps),
                            [p[i] for p in got], f"pic {i}")


# ---------------------------------------------------------------------------
# the wave and lane loops


@functools.lru_cache(maxsize=None)
def _jax_wave(name):
    from minivideo_tpu.ops.recon_wave import reconstruct_frames_wave
    return _numpy(reconstruct_frames_wave(_raster(name)))


@pytest.mark.parametrize("name", ["kinds_pcm", "slices", "qp0", "qp51",
                                  "lists"])
def test_wave_matches_jax(name):
    """reconstruct_frames_wave(device="cpu") equals the JAX package's
    reconstruct_frames_wave, plane for plane."""
    import torch
    from minivideo_tpu_torch.ops.recon_wave import reconstruct_frames_wave
    got = reconstruct_frames_wave(_port(_raster(name)), "cpu")
    assert all(p.dtype == torch.uint8 and p.device.type == "cpu"
               for p in got)
    assert_planes_equal(_jax_wave(name), _numpy(got), name)


def test_lane_matches_jax():
    """reconstruct_frames_lane(device="cpu") equals the JAX package's
    reconstruct_frames_lane (and the wave loop) on every stream, the
    CABAC one included."""
    from minivideo_tpu.ops.recon_lane import reconstruct_frames_lane as jl
    from minivideo_tpu_torch.ops.recon_lane import reconstruct_frames_lane
    for name in STREAMS:
        want = _numpy(jl(_raster(name)))
        got = _numpy(reconstruct_frames_lane(_port(_raster(name)), "cpu"))
        assert_planes_equal(want, got, name)
        if name != "cabac":
            assert_planes_equal(_jax_wave(name), got, f"{name} vs wave")


def test_integer_taps_match_selection_matrices():
    """The port's integer taps (_predict_lane, which the wave and lane
    loops both run) give the JAX package's selection-matrix predictions,
    int8 and exact-f32 alike, for every mode on random references,
    under every float32 matmul precision setting."""
    import jax.numpy as jnp
    import torch
    from minivideo_tpu.ops import recon_wave as J
    from minivideo_tpu_torch.ops import recon_lane as L
    from minivideo_tpu_torch.ops import recon_wave as T
    np.testing.assert_array_equal(T._SEL4[0], J._SEL4[0])
    np.testing.assert_array_equal(T._SEL8[0], J._SEL8[0])
    rng = np.random.default_rng(7)
    for n, sel_i8, sel_f32 in ((4, J._SEL4_I8, J._SEL4),
                               (8, J._SEL8_I8, J._SEL8)):
        S = 3 * n + 1
        s = rng.integers(0, 256, (50, 9, S)).astype(np.int32)
        mode = np.broadcast_to(np.arange(9, dtype=np.int32), (50, 9))
        dc = rng.integers(0, 256, (50, 9)).astype(np.int32)
        want = [np.asarray(J._predict_flat(
            jnp.asarray(s), tuple(jnp.asarray(x) for x in sel), mode, dc, n))
            for sel in (sel_i8, sel_f32)]
        np.testing.assert_array_equal(want[0], want[1])
        # the lane layout: samples [S, L], one mode per lane
        for prec in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(prec)
            try:
                for m in range(9):
                    lane = L._predict_lane(
                        torch.as_tensor(np.ascontiguousarray(s[:, m].T)),
                        torch.full((1, 50), m, dtype=torch.int32),
                        torch.as_tensor(dc[:, m][None]), n)
                    np.testing.assert_array_equal(
                        want[0][:, m].reshape(50, n * n), lane.numpy().T,
                        err_msg=f"lane n={n} mode {m} {prec}")
            finally:
                torch.set_float32_matmul_precision("highest")

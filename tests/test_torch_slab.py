"""The port's plain residual stage (ops/slab.residual_from_slabs) equals
the JAX function, bit for bit, on real stream feeds and on random slabs,
with the 8x8 and PCM paths on and off, at QP 0, 12 and 51.
(torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

import numpy as np
import jax.numpy as jnp
import pytest

from fixtures.h264enc import make_stream
from minivideo_tpu.ops import slab as jslab
from torch_port_helpers import jax_packed


def _jax_res(coefL, coefC, dcs, meta, ls4, ls8, has8x8, haspcm):
    t4, t8, tcb, tcr = jslab.scale_tables(ls4, ls8)
    rl, rc = jslab.residual_from_slabs(
        jnp.asarray(coefL), jnp.asarray(coefC), jnp.asarray(dcs),
        jnp.asarray(meta), t4, t8, tcb, tcr,
        jnp.asarray(jslab.P4), jnp.asarray(jslab.P8), jnp.asarray(jslab.PC),
        jnp.asarray(jslab.HH16), jnp.asarray(jslab.HH8C),
        has8x8=has8x8, haspcm=haspcm)
    return np.asarray(rl), np.asarray(rc)


def _torch_res(coefL, coefC, dcs, meta, ls4, ls8, has8x8, haspcm):
    import torch
    from minivideo_tpu_torch.ops import slab as tslab
    tabs = [torch.as_tensor(t) for t in tslab.scale_tables(ls4, ls8)]
    rl, rc = tslab.residual_from_slabs(
        torch.as_tensor(coefL), torch.as_tensor(coefC), torch.as_tensor(dcs),
        torch.as_tensor(meta), *tabs, has8x8=has8x8, haspcm=haspcm)
    assert rl.dtype == torch.int32 and rc.dtype == torch.int32
    return rl.numpy(), rc.numpy()


def _compare(*args):
    (jl, jc), (tl, tc) = _jax_res(*args), _torch_res(*args)
    np.testing.assert_array_equal(jl, tl, err_msg="luma residuals")
    np.testing.assert_array_equal(jc, tc, err_msg="chroma residuals")


def _random_wave(seed, qp, L=48, mag=400):
    """Random slabs for L lanes: kinds 0..3, one QP for all lanes."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, L)
    coefL = rng.integers(-mag, mag + 1, (256, L)).astype(np.int32)
    coefC = rng.integers(-mag, mag + 1, (128, L)).astype(np.int32)
    pcm = kind == 2
    coefL[:, pcm] = rng.integers(0, 256, (256, pcm.sum()))
    coefC[:, pcm] = rng.integers(0, 256, (128, pcm.sum()))
    dcs = np.zeros((jslab.DC_ROWS, L), np.int32)
    dcs[:24] = rng.integers(-mag, mag + 1, (24, L))
    meta = np.zeros((jslab.META_ROWS, L), np.int32)
    meta[jslab.R_KIND] = kind
    meta[jslab.R_PARSED] = 1
    qpc = np.clip(qp + rng.integers(-12, 13, 2), 0, 39)
    for row, q in ((jslab.R_YM6, qp), (jslab.R_CBM6, qpc[0]),
                   (jslab.R_CRM6, qpc[1])):
        meta[row] = q % 6
        meta[row + 1] = q // 6
    return coefL, coefC, dcs, meta


def _tables(seed):
    from minivideo_tpu.ops.transform import (level_scale_4x4_np,
                                             level_scale_8x8_np)
    rng = np.random.default_rng(seed)
    ls4 = np.stack([level_scale_4x4_np(rng.integers(4, 40, 16))
                    for _ in range(3)])
    return ls4, level_scale_8x8_np(rng.integers(4, 40, 64))


@pytest.mark.parametrize("qp", [0, 12, 51])
@pytest.mark.parametrize("has8x8,haspcm", [(True, True), (False, False),
                                           (True, False), (False, True)])
def test_random_slabs(qp, has8x8, haspcm):
    _compare(*_random_wave(qp + 7, qp), *_tables(qp), has8x8, haspcm)


@pytest.mark.parametrize("qp", [0, 12, 51])
def test_stream_feeds(qp):
    """All waves of a real 3-picture stream (every MB kind incl. PCM and
    8x8) as one giant wave of lanes."""
    data = make_stream(width_mbs=5, height_mbs=4, n_pictures=3, seed=60 + qp,
                       qp=qp, profile=100, transform_8x8=True,
                       mb_kinds=("i16", "i4", "i8"), density=0.45,
                       allow_pcm=True)
    packed, _, _, _ = jax_packed(data)
    a = packed.arrays

    def lanes(x):                     # [B, W, S, maxw] -> [S, B*W*maxw]
        return np.ascontiguousarray(
            x.transpose(2, 0, 1, 3).reshape(x.shape[2], -1)).astype(np.int32)

    args = (lanes(a["luma_slab"]), lanes(a["chroma_slab"]),
            lanes(a["dc_slab"]), lanes(a["meta_slab"]),
            packed.ls4, packed.ls8)
    _compare(*args, True, True)
    _compare(*args, packed.has8x8, packed.haspcm)

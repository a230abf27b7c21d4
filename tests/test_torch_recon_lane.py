"""The port's plain per-wave prediction (ops/recon_lane.wave_compute_lane)
equals the JAX function, bit for bit, on random references, modes and
availability flags, with the 8x8 and PCM paths on and off.
(torch and the port are imported inside the tests: see
torch_port_helpers.py.)"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from minivideo_tpu.ops import recon_lane as jlane


def _inputs(seed, L=40):
    rng = np.random.default_rng(seed)

    def ints(shape, lo, hi):
        return rng.integers(lo, hi, shape).astype(np.int32)

    def flag():
        return rng.random((1, L)) < 0.7

    return dict(
        left_col=ints((16, L), 0, 256), corner=ints((1, L), 0, 256),
        top_row=ints((16, L), 0, 256), tr_row=ints((16, L), 0, 256),
        left_c=ints((16, L), 0, 256), corner_cb=ints((1, L), 0, 256),
        corner_cr=ints((1, L), 0, 256), top_c=ints((16, L), 0, 256),
        kind=ints((1, L), 0, 4), al=flag(), at=flag(), atl=flag(),
        atr=flag(), parsed=ints((1, L), 0, 2) | (rng.random((1, L)) < 0.8),
        modes4=ints((16, L), 0, 9), modes8=ints((4, L), 0, 9),
        i16_mode=ints((1, L), 0, 4), cmode=ints((1, L), 0, 4),
        res_luma=ints((256, L), -300, 301),
        res_chroma=ints((128, L), -300, 301))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("has8x8,haspcm", [(True, True), (False, False)])
def test_wave_compute_lane(seed, has8x8, haspcm):
    import torch
    from minivideo_tpu_torch.ops import recon_lane as tlane
    kw = _inputs(seed)
    kw["parsed"] = kw["parsed"].astype(np.int32)
    fn = jax.jit(partial(jlane.wave_compute_lane, has8x8=has8x8,
                         haspcm=haspcm))
    want = fn(**{k: jnp.asarray(v) for k, v in kw.items()})
    got = tlane.wave_compute_lane(
        **{k: torch.as_tensor(v) for k, v in kw.items()},
        has8x8=has8x8, haspcm=haspcm)
    for name, a, b in zip(("tile", "ctile"), want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)


def test_all_unavailable_and_unparsed():
    """No neighbours anywhere (DC 128 paths) and unparsed lanes (zeros)."""
    import torch
    from minivideo_tpu_torch.ops import recon_lane as tlane
    kw = _inputs(5)
    for k in ("al", "at", "atl", "atr"):
        kw[k] = np.zeros_like(kw[k])
    kw["parsed"] = (np.arange(40) % 3 != 0).astype(np.int32)[None]
    kw["modes4"][:] = 2
    kw["modes8"][:] = 2
    want = jax.jit(jlane.wave_compute_lane)(
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tlane.wave_compute_lane(**{k: torch.as_tensor(v)
                                     for k, v in kw.items()})
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

"""The port's tile-to-raster interleave (ops/interleave.py) equals the
formulation that tools/probe_interleave.py holds its Pallas DMA kernel
against (`xla_t`: reshape, transpose(0, 1, 3, 2, 4), reshape), run through
jax.numpy on the CPU, on the same numpy-seeded tiles, with tolerance 0.
The probe's kernel sits inside its main(), so the test repeats its
reference formulation here.  (The CUDA kernel is held against the plain
version in test_torch_gpu.py; torch and the port are imported inside the
tests: see torch_port_helpers.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest


def _xla_t(X, B, hmb, wmb):
    """tools/probe_interleave.py:69-71."""
    t = X.reshape(B, hmb, wmb, 16, 16).transpose(0, 1, 3, 2, 4)
    return t.reshape(B, hmb * 16, wmb * 16)


@pytest.mark.parametrize("B,wmb,hmb", [(2, 7, 5), (1, 120, 3), (3, 1, 1),
                                       (2, 120, 68)])
def test_plain_matches_probe_reference(B, wmb, hmb):
    import torch
    from minivideo_tpu_torch.ops import interleave
    rng = np.random.default_rng(B * 1000 + wmb * 10 + hmb)
    tiles = rng.integers(0, 256, (B, hmb * wmb, 256), np.uint8)
    want = np.asarray(_xla_t(jnp.asarray(tiles), B, hmb, wmb))
    launches = interleave.tiles_to_raster_cuda.launches
    got = interleave.tiles_to_raster_plain(torch.from_numpy(tiles), wmb, hmb)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert interleave.tiles_to_raster_cuda.launches == launches


def test_wrapper_checks():
    import torch
    from minivideo_tpu_torch.ops import interleave
    tiles = torch.zeros((2, 35, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        interleave.tiles_to_raster_cuda(tiles, 7, 5)
    with pytest.raises(ValueError, match="shape"):
        interleave.tiles_to_raster_cuda(tiles, 5, 5)
    with pytest.raises(TypeError):
        interleave.tiles_to_raster_cuda(tiles.int(), 7, 5)
    with pytest.raises(ValueError, match="shape"):
        interleave.tiles_to_raster_plain(tiles, 5, 5)

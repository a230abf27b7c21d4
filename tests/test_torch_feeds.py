"""The port's raster and slot-record feeds (ops/slab.py, torch ops) equal
the JAX package's (through jax.numpy) with tolerance 0: each port feed
emits [B, W, S, maxw], and x.permute(1, 2, 0, 3).reshape(W, S, B*maxw) of
it is the JAX function's [W, S, B*maxw].  (torch and the port are
imported inside the tests: see torch_port_helpers.py; the decodes of each
layout are in test_torch_layouts.py.)"""

import numpy as np
import pytest

import jax.numpy as jnp

from fixtures.h264enc import make_stream
from minivideo_tpu.ops import slab as jsl
from minivideo_tpu.ops.recon_wave import skew_tables
from torch_port_helpers import jax_staging


def cavlc_stream():
    return make_stream(width_mbs=6, height_mbs=4, n_pictures=3, seed=50,
                       profile=100, transform_8x8=True,
                       mb_kinds=("i16", "i4", "i8"), n_slices=3,
                       allow_pcm=True)


def _staging(layout):
    """JAX-package PackedFrames of cavlc_stream() in `layout`, with the
    skew tables."""
    packed = jax_staging(cavlc_stream(), layout)
    assert packed.haspcm
    return packed, skew_tables(packed.wmb, packed.hmb)


def _t(arrays):
    import torch
    return {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}


def _wsl(x, W, S):
    """Port [B, W, S, maxw] -> the JAX feed layout [W, S, B*maxw]."""
    return x.permute(1, 2, 0, 3).reshape(W, S, -1).numpy()


def _assert_eq(want, got, what):
    want = np.asarray(want)
    assert want.shape == got.shape, f"{what}: {want.shape} {got.shape}"
    assert want.dtype == got.dtype, f"{what}: {want.dtype} {got.dtype}"
    np.testing.assert_array_equal(want, got, err_msg=what)


FEEDS = ("meta_raster", "slabs_from_raster", "skew_feed", "skew_feed_slab",
         "slot_feed", "vmask_feed")


@pytest.mark.parametrize("fn", FEEDS)
def test_feed_matches_jax(fn):
    from minivideo_tpu_torch.ops import slab as tsl
    layout = "records" if fn == "slot_feed" else "raster"
    packed, g = _staging(layout)
    B, W, maxw = packed.batch, g["n_waves"], g["maxw"]
    cb, cr = packed.chroma_qp_off
    jarr = {k: jnp.asarray(v) for k, v in packed.arrays.items()}
    tarr = _t(packed.arrays)
    jmeta = jsl.meta_raster(jarr, cb, cr, packed.wmb, packed.hmb)
    tmeta = tsl.meta_raster(tarr, cb, cr, packed.wmb, packed.hmb)
    if fn == "meta_raster":
        _assert_eq(jmeta, tmeta.numpy(), fn)
    elif fn == "slabs_from_raster":
        for j, t in zip(jsl.slabs_from_raster(jarr),
                        tsl.slabs_from_raster(tarr)):
            _assert_eq(j, t.numpy(), fn)
    elif fn == "skew_feed":
        _assert_eq(jsl.skew_feed(jmeta, g, B),
                   _wsl(tsl.skew_feed(tmeta, g, B), W, jsl.META_ROWS), fn)
    elif fn == "skew_feed_slab":
        for j, t in zip(jsl.slabs_from_raster(jarr),
                        tsl.slabs_from_raster(tarr)):
            _assert_eq(jsl.skew_feed_slab(j, g, B),
                       _wsl(tsl.skew_feed_slab(t, g, B), W, t.shape[-1]), fn)
    elif fn == "slot_feed":
        import torch
        for k in ("luma_slab", "chroma_slab", "dc_slab"):
            S = packed.arrays[k].shape[-1]
            for jd, td in ((jnp.int32, torch.int32),
                           (jnp.int16, torch.int16)):
                _assert_eq(jsl.slot_feed(jarr[k], g, B, jd),
                           _wsl(tsl.slot_feed(tarr[k], g, B, td), W, S), k)
    else:
        want = jsl.vmask_feed(jsl.skew_feed(jmeta, g, B), g, B)
        got = tsl.vmask_feed(tsl.skew_feed(tmeta, g, B), g, B)
        _assert_eq(want, _wsl(got, W, jsl.META_ROWS), fn)
        assert got.shape == (B, W, jsl.META_ROWS, maxw)


@pytest.mark.parametrize("layout", ["raster", "records"])
def test_layout_feeds_match_jax(layout):
    """recon_fused.raster_feeds / records_feeds: the four kernel feeds,
    with the JAX reconstructors' int16 casts."""
    from minivideo_tpu_torch.ops import recon_fused as tfused
    packed, g = _staging(layout)
    B, W = packed.batch, g["n_waves"]
    cb, cr = packed.chroma_qp_off
    jarr = {k: jnp.asarray(v) for k, v in packed.arrays.items()}
    jmeta = jsl.vmask_feed(jsl.skew_feed(
        jsl.meta_raster(jarr, cb, cr, packed.wmb, packed.hmb), g, B), g, B)
    if layout == "raster":
        want = [jmeta] + [jsl.skew_feed_slab(x, g, B).astype(jnp.int16)
                          for x in jsl.slabs_from_raster(jarr)]
        feeds = tfused.raster_feeds
    else:
        want = [jmeta] + [jsl.slot_feed(jarr[k], g, B, jnp.int16)
                          for k in ("luma_slab", "chroma_slab", "dc_slab")]
        feeds = tfused.records_feeds
    got = feeds(_t(packed.arrays), cb, cr, packed.wmb, packed.hmb, B)
    for name, w, t in zip(tfused.DEVICE_STAGING, want, got):
        assert t.is_contiguous()
        _assert_eq(w, _wsl(t, W, t.shape[2]), name)

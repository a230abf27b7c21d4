"""Every staging layout of the port decodes to the JAX package's planes
(tolerance 0): the device and records layouts (MINIVIDEO_TPU_STAGING),
the raster layout (the full native parse, pack_frames, reconstruct_batch)
and the Python parsers (MINIVIDEO_TPU_NO_NATIVE=1), against
decode_annexb(engine="fused") of the JAX package; JAX-package staging of
each layout carried across by packed_from_numpy reconstructs as the JAX
package's fused engine does; and settings.staging_mode reads
MINIVIDEO_TPU_STAGING.  (torch and the port are imported inside the
tests: see torch_port_helpers.py.)"""

import functools

import numpy as np
import pytest

from fixtures.h264enc import make_stream
from fixtures.h264enc2 import make_stream2
from minivideo_tpu.models.h264.decoder import decode_annexb as j_decode
from minivideo_tpu.ops.recon_fused import reconstruct_frames_fused as j_recon
from torch_port_helpers import assert_planes_equal, jax_staging

STREAMS = {
    "cavlc": lambda: make_stream(
        width_mbs=6, height_mbs=4, n_pictures=3, seed=50, profile=100,
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3,
        allow_pcm=True),
    "cabac": lambda: make_stream2(
        width_mbs=5, height_mbs=4, n_pictures=2, seed=51, entropy="cabac",
        transform_8x8=True, mb_kinds=("i16", "i4", "i8"), n_slices=3,
        allow_pcm=True),
}


@functools.lru_cache(maxsize=None)
def _jax_pictures(name):
    """The JAX package's decode_annexb(engine="fused") of STREAMS[name]
    (device staging), once per worker: every layout is held against it."""
    import os
    old = os.environ.get("MINIVIDEO_TPU_STAGING")
    os.environ["MINIVIDEO_TPU_STAGING"] = "device"
    try:
        return j_decode(STREAMS[name](), engine="fused")
    finally:
        if old is None:
            del os.environ["MINIVIDEO_TPU_STAGING"]
        else:
            os.environ["MINIVIDEO_TPU_STAGING"] = old


def _port_decode(data, layout):
    from minivideo_tpu_torch.models.h264.decoder import (H264Decoder,
                                                        decode_annexb,
                                                        stage_annexb)
    if layout != "raster":
        return decode_annexb(data, device="cpu")
    dec = H264Decoder(device="cpu")
    return [p for parsed, packed in stage_annexb(data, "cpu",
                                                 staging_mode="raster")
            for p in dec.reconstruct_batch(parsed, packed)]


@pytest.mark.parametrize("layout", ["device", "records", "raster",
                                    "no_native"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_layout_planes_match_jax(name, layout, monkeypatch):
    data = STREAMS[name]()
    want = _jax_pictures(name)
    if layout == "no_native":
        monkeypatch.setenv("MINIVIDEO_TPU_NO_NATIVE", "1")
    elif layout != "raster":
        monkeypatch.setenv("MINIVIDEO_TPU_STAGING", layout)
    got = _port_decode(data, layout)
    assert len(got) == len(want) > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.idr_index == g.idr_index
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr),
                            f"{name} {layout} pic {i}")


@pytest.mark.parametrize("layout", ["raster", "records", "device"])
def test_packed_from_numpy_layouts(layout):
    """JAX-package staging of each layout (slots 0, 1, 2) carried across
    reconstructs to the JAX package's fused planes."""
    from minivideo_tpu_torch.convert import packed_from_numpy
    from minivideo_tpu_torch.ops.recon_fused import reconstruct_frames_fused
    packed = jax_staging(STREAMS["cavlc"](), layout)
    want = [np.asarray(a) for a in j_recon(packed, interpret=True)]
    tp = packed_from_numpy(packed, device="cpu")
    assert tp.slots == packed.slots == ("raster", "records",
                                        "device").index(layout)
    assert (tp.batch, tp.haspcm) == (packed.batch, packed.haspcm)
    assert_planes_equal(want, reconstruct_frames_fused(tp), layout)


def test_staging_mode_env(monkeypatch):
    from minivideo_tpu_torch import settings
    for mode in ("records", "device"):
        monkeypatch.setenv("MINIVIDEO_TPU_STAGING", mode)
        assert settings.staging_mode() == mode
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "auto")
    cores = settings.os.cpu_count() or 1
    rates = {m: settings.staging_throughput(cores, m)
             for m in ("device", "records")}
    assert settings.staging_mode() == (
        "device" if rates["device"] >= rates["records"] else "records")
    for mode in ("records", "device"):
        assert settings.staging_throughput(1, mode) > 0
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", "bogus")
    with pytest.raises(ValueError, match="MINIVIDEO_TPU_STAGING"):
        settings.staging_mode()

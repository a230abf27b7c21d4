"""Bad slices: the port drops the IDR pictures whose parse fails, as the
JAX package (and the reference, h264.c:181-187) does.  On streams with a
truncated IDR picture, two streams joined end to end that reuse SPS/PPS
id 0, and a run of more than 64 bad pictures (testing/streams.py
BAD_STREAMS), the port returns the JAX package's pictures in count and
planes, through both slab staging layouts.  A failure of the staging copy
or of the reconstruction is not a parse error: it still raises.  (torch
and the port are imported inside the tests: see torch_port_helpers.py.)"""

import functools

import pytest

from fixtures.h264enc import make_stream
from minivideo_tpu.models.h264.decoder import decode_annexb as j_decode
from torch_port_helpers import assert_planes_equal

BAD = ("truncated_idr", "joined_id0", "error_run")
# pictures the JAX package returns for each (checked below as well)
COUNTS = {"truncated_idr": 2, "joined_id0": 2, "error_run": 3}


def _bad(name):
    from minivideo_tpu_torch.testing.streams import bad_stream
    return bad_stream(name, make_stream)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's pictures of _bad(name) with engine "fused", once
    per worker, after checking that its numpy engine returns as many."""
    data = _bad(name)
    want = j_decode(data, engine="fused")
    assert len(want) == len(j_decode(data, engine="np")) == COUNTS[name]
    return want


@pytest.mark.parametrize("layout", ["device", "records"])
@pytest.mark.parametrize("name", BAD)
def test_bad_stream_matches_reference(name, layout, monkeypatch):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    monkeypatch.setenv("MINIVIDEO_TPU_STAGING", layout)
    want = _reference(name)
    got = decode_annexb(_bad(name), device="cpu")
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.idr_index == g.idr_index
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr),
                            f"{name} {layout} pic {i}")


@pytest.mark.parametrize("name", BAD)
def test_bad_stream_python_parsers(name, monkeypatch):
    """Under MINIVIDEO_TPU_NO_NATIVE=1 the Python parsers drop the same
    pictures."""
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    monkeypatch.setenv("MINIVIDEO_TPU_NO_NATIVE", "1")
    want = _reference(name)
    got = decode_annexb(_bad(name), device="cpu")
    assert len(got) == len(want) == COUNTS[name]
    for w, g in zip(want, got):
        assert_planes_equal((w.y, w.cb, w.cr), (g.y, g.cb, g.cr), name)


def test_slab_failure_warns_and_falls_back(capfd):
    from minivideo_tpu_torch.models.h264.decoder import decode_annexb
    assert len(decode_annexb(_bad("truncated_idr"), device="cpu")) == 2
    err = capfd.readouterr().err
    assert "slab parse failed" in err and "falling back to raster" in err
    assert "IDR parse error" in err


@pytest.mark.parametrize("where", ["copy", "reconstruction"])
@pytest.mark.parametrize("name", ["good", "truncated_idr"])
def test_device_errors_raise(name, where, monkeypatch):
    """A RuntimeError from the staging copy or from the reconstruction
    (a CUDA error, a timed-out row wait) propagates, on the slab path and
    on the raster path after a parse failure: no picture is dropped for
    it and nothing runs again elsewhere."""
    from minivideo_tpu_torch.models.h264 import decoder as tdec
    from minivideo_tpu_torch.ops import recon_fused

    calls = []

    def boom(*a, **k):
        calls.append(where)
        raise RuntimeError("injected device failure")

    target = ("to_device" if where == "copy"
              else "make_reconstruct_fused_slots2")
    monkeypatch.setattr(recon_fused, target, boom)
    data = (make_stream(width_mbs=4, height_mbs=3, n_pictures=2, seed=5)
            if name == "good" else _bad(name))
    with pytest.raises(RuntimeError, match="injected device failure"):
        tdec.decode_annexb(data, device="cpu")
    assert calls == [where]         # raised at once, not retried

"""The port's geometry and constant tables equal the JAX package's:
skew tables, wave schedule, segment masks, slab layout constants, scale
tables and the prediction selection matrices (tolerance 0).
(The port is imported by the `port` fixture, not at collection: see
torch_port_helpers.py.)"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

from minivideo_tpu.ops import recon_fused as jfused
from minivideo_tpu.ops import recon_lane as jlane
from minivideo_tpu.ops import recon_wave as jwave
from minivideo_tpu.ops import slab as jslab
from minivideo_tpu.ops.predtables import PRED4 as J_PRED4, PRED8 as J_PRED8
from minivideo_tpu.ops.recon import _TR4_CLASS as J_TR4
from minivideo_tpu.ops.transform import (level_scale_4x4_np as j_ls4,
                                         level_scale_8x8_np as j_ls8)

GEOMS = [(1, 1), (4, 3), (5, 4), (2, 7), (9, 2), (120, 68)]


@pytest.fixture(scope="module")
def port():
    from minivideo_tpu_torch.ops import (predtables, recon, recon_fused,
                                         recon_lane, recon_wave, slab,
                                         transform)
    return SimpleNamespace(predtables=predtables, recon=recon,
                           fused=recon_fused, lane=recon_lane,
                           wave=recon_wave, slab=slab, transform=transform)


@pytest.mark.parametrize("wmb,hmb", GEOMS)
def test_skew_tables_and_wave_schedule(port, wmb, hmb):
    want = jwave.skew_tables(wmb, hmb)
    got = port.wave.skew_tables(wmb, hmb)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      np.asarray(got[k]), err_msg=k)
    for a, b in zip(jfused.wave_schedule(want),
                    port.fused.wave_schedule(got)):
        np.testing.assert_array_equal(a, b)


def test_skew_tables_1080p_shape(port):
    g = port.wave.skew_tables(120, 68)
    assert (g["n_waves"], g["maxw"]) == (254, 61)


def test_seg_masks(port):
    for maxw, batch in ((1, 1), (3, 2), (61, 16)):
        for a, b in zip(jfused._seg_masks(maxw, batch),
                        port.fused._seg_masks(maxw, batch)):
            np.testing.assert_array_equal(a, b)


def test_slab_constants(port):
    tslab = port.slab
    for name in ("P4", "P8", "PC", "HH16", "HH8C"):
        np.testing.assert_array_equal(getattr(jslab, name),
                                      getattr(tslab, name), err_msg=name)
    for name in ("META_ROWS", "DC_ROWS", "R_KIND", "R_PARSED", "R_AL",
                 "R_AT", "R_ATL", "R_ATR", "R_I16M", "R_CMODE", "R_MODES8",
                 "R_MODES4", "R_YM6", "R_YDIV", "R_CBM6", "R_CBDIV",
                 "R_CRM6", "R_CRDIV"):
        assert getattr(jslab, name) == getattr(tslab, name), name
    # the integer gathers are the permutation matrices' single 1s
    for P, perm in ((tslab.P4, tslab.PERM4), (tslab.P8, tslab.PERM8),
                    (tslab.PC, tslab.PERMC)):
        assert (P.sum(1) == 1).all() and (P.sum(0) == 1).all()
        np.testing.assert_array_equal(P[np.arange(len(perm)), perm], 1)


def test_scale_tables(port):
    rng = np.random.default_rng(0)
    for _ in range(3):
        l4 = [rng.integers(1, 256, 16) for _ in range(3)]
        l8 = rng.integers(1, 256, 64)
        ls4 = np.stack([port.transform.level_scale_4x4_np(x) for x in l4])
        ls8 = port.transform.level_scale_8x8_np(l8)
        np.testing.assert_array_equal(ls4, np.stack([j_ls4(x) for x in l4]))
        np.testing.assert_array_equal(ls8, j_ls8(l8))
        for a, b in zip(jslab.scale_tables(ls4, ls8),
                        port.slab.scale_tables(ls4, ls8)):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(np.asarray(a), b)


def test_selection_matrices(port):
    np.testing.assert_array_equal(jlane._SEL4_T, port.lane._SEL4_T)
    np.testing.assert_array_equal(jlane._SEL8_T, port.lane._SEL8_T)
    for a, b in zip(J_PRED4 + J_PRED8,
                    port.predtables.PRED4 + port.predtables.PRED8):
        np.testing.assert_array_equal(a, b)
    assert jwave._BLK_X == port.wave._BLK_X
    assert jwave._BLK_Y == port.wave._BLK_Y


def test_tr4_class(port):
    np.testing.assert_array_equal(J_TR4, port.recon._TR4_CLASS)


def test_cuda_kernel_tables_match_python(port):
    """The constant tables written into csrc/wave_kernel.cu (4x4 block
    order, in-MB top-right availability) equal the Python ones."""
    src = open(os.path.join(os.path.dirname(port.fused.__file__), "csrc",
                            "wave_kernel.cu")).read()

    def table(name):
        m = re.search(name + r"\[16\] = \{([^}]*)\}", src)
        return [int(v) for v in m.group(1).split(",")]

    assert table("kBlkX") == port.wave._BLK_X
    assert table("kBlkY") == port.wave._BLK_Y
    assert table("kTrIn") == [int(c == 1) for c in port.recon._TR4_CLASS]

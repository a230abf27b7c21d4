"""The plain reference: its decode against libavcodec's digests on every
picture of every committed stream, its control, the JPEG check against
the port's native writer, and the exact encoder of the control."""

import hashlib

import numpy as np
import pytest

from tvbench import inputs
from tvbench.reference import decode as ref
from tvbench.reference import jpg
from tvbench.reference.h264 import transform_np as T

from .conftest import tiny_config


def _lavc_planes(planes):
    return [hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()
            for p in planes]


def test_tiny_pictures_are_libavcodec_s():
    config = tiny_config()
    s = config["streams"]["tiny"]
    data = inputs.stream(config, "tiny")
    for k, want in enumerate(s["libavcodec_planes_sha256"]):
        planes, size = ref.decode_picture(data, k)
        assert list(size) == s["display_size"]
        assert _lavc_planes(ref.cropped(planes, size)) == want
        assert ref.planes_sha256(*ref.cropped(planes, size)) == \
            s["libavcodec_sha256"][k]


def _streams():
    """(configuration, stream key, picture) of every picture of every
    committed stream of the benchmark's configurations."""
    out = []
    for c in inputs.benchmark()["configs"]:
        config = inputs.part("configs", c["name"])
        for key, s in sorted(config["streams"].items()):
            out += [(c["name"], key, k) for k in range(s["pictures"])]
    return out


@pytest.mark.parametrize("name,key,picture", _streams())
def test_every_1080p_picture_is_libavcodec_s(name, key, picture):
    config = inputs.part("configs", name)
    s = config["streams"][key]
    planes, size = ref.decode_picture(inputs.stream(config, key), picture)
    assert list(size) == s["display_size"]
    assert ref.planes_sha256(*ref.cropped(planes, size)) == \
        s["libavcodec_sha256"][picture]


def test_float_transforms_are_the_standard_s_where_exact():
    rng = np.random.default_rng(0)
    t4, t8 = ref._T4.astype(np.float64), ref._T8.astype(np.float64)
    for _ in range(100):
        d = rng.integers(-64, 64, (4, 4)) * 4
        assert (T.idct_4x4(d) == np.floor(t4 @ d @ t4.T / 64 + .5)).all()
        d = rng.integers(-64, 64, (8, 8)) * 64
        assert (T.idct_8x8(d) == np.floor(t8 @ d @ t8.T / 64 + .5)).all()


def test_control_differs_from_the_reference():
    data = inputs.stream(tiny_config(), "tiny")
    for k in range(2):
        a, size = ref.decode_picture(data, k)
        b, _ = ref.decode_picture(data, k, control=True)
        assert ref.planes_sha256(*a) != ref.planes_sha256(*b)
        # the control's thumbnail fails the JPEG check too
        control = jpg.encode(ref.cropped(b, size), 75)
        assert jpg.check_file(control, ref.cropped(b, size), 75)[
            "bad_blocks"] == 0
        assert jpg.check_file(control, ref.cropped(a, size), 75)[
            "bad_blocks"] > 0


@pytest.mark.parametrize("quality", [75, 30, 95])
def test_native_jpeg_passes_and_other_quality_fails(quality):
    from minivideo_tpu_torch import native
    data = inputs.stream(tiny_config(), "tiny")
    planes, size = ref.decode_picture(data, 1)
    crop = [np.ascontiguousarray(p) for p in ref.cropped(planes, size)]
    file = native.encode_jpeg_native(*crop, quality)
    ok = jpg.check_file(file, crop, quality)
    assert ok["bad_blocks"] == 0 and ok["worst_excess"] < jpg.MARGIN
    assert jpg.check_file(file, crop, quality - 1)["bad_blocks"] > 0
    assert jpg.check_file(file[:len(file) // 2], crop,
                           quality)["bad_blocks"] == ok["blocks"]
    crop[0] = crop[0].copy()
    crop[0][40:48, 40:48] ^= 8
    assert jpg.check_file(file, crop, quality)["bad_blocks"] > 0


@pytest.mark.parametrize("size", [(128, 96), (40, 24), (56, 40)])
def test_the_exact_encoder_passes_its_own_check(size):
    w, h = size
    rng = np.random.default_rng(w)
    planes = (rng.integers(0, 256, (h, w), dtype=np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    file = jpg.encode(planes, 75)
    ok = jpg.check_file(file, planes, 75)
    assert ok["bad_blocks"] == 0 and ok["blocks"] == jpg.blocks(w, h)
    read = jpg.read_jpeg(file)
    want = jpg.exact(planes, 75)
    for got, exact in zip(read["coef"], want):
        assert (got == np.rint(exact)).all()
    assert jpg.check_file(file, planes, 70)["bad_blocks"] > 0

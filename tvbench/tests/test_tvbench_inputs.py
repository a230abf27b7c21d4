"""The one generator of the inputs: the same files for a seed, the same
pictures in another order for another seed."""

import hashlib
import os

import pytest

from tvbench import inputs

from .conftest import MIXES, tiny_config


def _digests(files):
    return [hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p, _ in files]


def test_reorder_keeps_every_picture():
    data = inputs.stream(tiny_config(), "tiny")
    def slices(d):
        return [[u for u in g if u[0] & 0x1F == 5]
                for g in inputs.pictures_of(d)]
    groups = slices(data)
    assert slices(inputs.reorder(data, [1, 0])) == [groups[1], groups[0]]
    assert inputs.reorder(data, [0, 1]) != inputs.reorder(data, [1, 0])
    # the tiny stream's pictures are 4 slices each, kept together
    assert all(len(g) == 4 for g in groups)
    config = inputs.part("configs", "thumbnailer-1080p-jpg")
    big = inputs.stream(config, "cabac_8x8")
    assert len(inputs.pictures_of(big)) == 8


def test_files_repeat_for_a_seed(tmp_path):
    config, mix = tiny_config(), MIXES["batch"]
    a = inputs.write_files(config, mix, 2**33 + 5, str(tmp_path / "a"))
    b = inputs.write_files(config, mix, 2**33 + 5, str(tmp_path / "b"))
    c = inputs.write_files(config, mix, 7, str(tmp_path / "c"))
    assert _digests(a) == _digests(b)
    assert [k for _, k in a] == [k for _, k in b]
    assert _digests(a) != _digests(c)
    assert len(a) == mix["files"]
    assert all(os.path.getsize(p) > 0 for p, _ in a)


def test_containers_are_found_by_name():
    from tvbench.containers import writer
    from minivideo_tpu_torch.testing.containers import write_mp4
    data = inputs.stream(tiny_config(), "tiny")
    assert writer("mp4")(data, 128, 96) == write_mp4(data, 128, 96)
    with pytest.raises(ValueError):
        writer("../run")


def test_first_picture_is_the_thumbnail(tmp_path):
    from minivideo_tpu_torch.api import mv_close, mv_decode, mv_open, \
        mv_parse
    from tvbench.reference import decode as ref
    config = tiny_config()
    data = inputs.stream(config, "tiny")
    want = [ref.planes_sha256(*ref.cropped(*ref.decode_picture(data, k)))
            for k in range(2)]
    for path, first in inputs.write_files(config, MIXES["batch"], 11,
                                          str(tmp_path)):
        m = mv_open(path)
        mv_parse(m, audio=False, video=True, subs=False)
        pic = mv_decode(m, picture_number=1, device="cpu")[0]
        mv_close(m)
        assert ref.planes_sha256(*pic.cropped()) == want[first]

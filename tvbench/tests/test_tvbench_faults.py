"""A run of each driver at the tiny size on the CPU, sound and with the
timed path broken underneath: `correct` has to come out false for each
fault that the cell can have, and for the control in the program's
place."""

import pytest

from .conftest import MIXES, run_tiny


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_sound_runs_are_correct(kind, tmp_path, one_thread):
    out, notes = run_tiny(kind, tmp_path)
    assert out["correct"], (out, notes)
    assert notes["checked"]["pictures_compared"] > 0
    assert notes["checked"]["pictures_untapped"] == 0
    assert out["failed"] == 0 and out["attempted"] > 0
    for c in out["checks"].values():
        assert c == {"value": 0, "limit": 0}
    assert list(out)[-1] == "checks"
    if kind == "batch":
        assert notes["checked"]["files_held"] == \
            notes["checked"]["files_checked"] > 0


def _flip_one(planes):
    y = planes[0].clone()
    y[..., 3, 5] ^= 1
    return (y, *planes[1:])


def _alter(monkeypatch):
    """A sample altered where the planes are produced, on every path."""
    from minivideo_tpu_torch import bench
    from minivideo_tpu_torch.models.h264 import decoder
    from minivideo_tpu_torch.ops import recon_fused
    for mod in (decoder, recon_fused):
        orig = mod.reconstruct_frames_fused
        monkeypatch.setattr(mod, "reconstruct_frames_fused",
                            lambda *a, _o=orig, **k: _flip_one(_o(*a, **k)))
    orig = bench.Bench.recon
    monkeypatch.setattr(bench.Bench, "recon",
                        lambda self, *a, _o=orig: _flip_one(_o(self, *a)))


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_an_answer_altered_where_it_is_made(kind, tmp_path, monkeypatch,
                                            one_thread):
    _alter(monkeypatch)
    out, notes = run_tiny(kind, tmp_path)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0
    if kind == "batch":
        # no thumbnail of wrong planes is held to them: every block counts
        assert out["checks"]["jpeg_bad_blocks"]["value"] == \
            notes["checked"]["file_blocks"] > 0


def _left_out(monkeypatch):
    """Half of each batch left out: batch_thumbnail given half the clips;
    the pipeline's upper half of each batch never reconstructed."""
    import minivideo_tpu_torch.parallel as par
    from minivideo_tpu_torch import bench
    orig = par.batch_thumbnail
    monkeypatch.setattr(par, "batch_thumbnail",
                        lambda clips, *a, **k: orig(clips[:len(clips) // 2],
                                                    *a, **k))
    rec = bench.Bench.recon

    def half(self, *a):
        planes = rec(self, *a)
        out = []
        for p in planes:
            p = p.clone()
            p[p.shape[0] // 2:] = 0
            out.append(p)
        return tuple(out)
    monkeypatch.setattr(bench.Bench, "recon", half)


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_half_of_the_batch_left_out(kind, tmp_path, monkeypatch,
                                    one_thread):
    _left_out(monkeypatch)
    out, _ = run_tiny(kind, tmp_path)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def test_a_thumbnail_written_wrong(tmp_path, monkeypatch, one_thread):
    """Right planes, a thumbnail written at another quality."""
    from minivideo_tpu_torch.export import image
    orig = image.export_picture
    monkeypatch.setattr(
        image, "export_picture",
        lambda base, fmt, y, cb, cr, quality=75, rgb=None:
            orig(base, fmt, y, cb, cr, quality - 5, rgb=rgb))
    out, notes = run_tiny("batch", tmp_path)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] == 0
    assert out["checks"]["jpeg_bad_blocks"]["value"] > 0


def _window(kind, tmp_path):
    import torch
    from tvbench import drivers
    from .conftest import tiny_config
    config = tiny_config()
    if kind == "pipeline":
        config.pop("thumbnailer")
    d = drivers.load(MIXES[kind]["driver"])(
        config, MIXES[kind], 5, [torch.device("cpu")], str(tmp_path))
    d.setup(1)
    res = d.window()
    d.close()
    return d, res


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_the_control_in_the_program_s_place(kind, tmp_path, one_thread):
    """The control's planes and thumbnails go through the harness's own
    comparison, and `correct` comes out false; the reference's own, put
    in place the same way, pass."""
    from tvbench import control, inputs
    from tvbench.reference import decode as ref
    d, res = _window(kind, tmp_path)
    n = MIXES[kind].get("file_checks", 8)
    sound, ok, _ = control.reading(d, res["failed"], n)
    assert ok and all(v == 0 for v in sound.values())
    pictures = {a.picture for a in d.answers}
    data = inputs.stream(d.config, "tiny")
    control.put_in_place(d, {k: ref.decode_picture(data, k)[0]
                             for k in pictures}, n)
    same, ok, _ = control.reading(d, res["failed"], n)
    assert ok, same
    ctrl = control.control_planes(d.config, "tiny", pictures)
    control.put_in_place(d, ctrl, n)
    numbers, ok, parts = control.reading(d, res["failed"], n)
    assert not ok
    assert numbers["answers_wrong"] == len(d.answers) > 0
    if kind == "batch":
        assert numbers["jpeg_bad_blocks"] == parts["file_blocks"] > 0

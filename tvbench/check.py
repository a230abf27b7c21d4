"""The comparison that decides `correct`, and the import check.

After the window has closed and the program's state is freed, each
sampled answer is held to libavcodec's decode of the picture it should
show: the configuration pins, for every picture of its committed stream,
the SHA-256 of libavcodec's display planes (Y, Cb, Cr in that order), an
independent decoder's.  The plain reference decoder (reference/decode.py,
Python and NumPy alone) gives the same digest for every picture (its
tests), and is what the control puts in the program's place (control.py).

Two numbers are compared, each a count whose limit is 0 (decoded samples
are integers, and "close" is a failure):

  answers_wrong    answers due in the window that never came (a clip that
                   batch_thumbnail failed or left out), and sampled
                   pictures whose display planes differ from libavcodec's
                   in any sample or that the harness's tap did not see;
  jpeg_bad_blocks  (thumbnail cells; the number of the thumbnail format's
                   reference module, reference/<format>.py) 8x8 blocks of
                   the sampled thumbnail files whose quantised
                   coefficients are not each the rounding of the exact DCT
                   of the answer's planes over the quality's quantiser,
                   held only to planes that matched libavcodec's digest:
                   every block of a file whose planes did not match, or
                   that is missing or not a baseline 4:2:0 JPEG of the
                   picture's size.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

from . import inputs

FORBIDDEN = ("jax", "jaxlib", "flax", "minivideo_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def file_format(fmt: str):
    """reference/<fmt>.py: `NUMBER`, `blocks(w, h)`, `check_file(data,
    planes, quality)` and `encode(planes, quality)` of a thumbnail
    format."""
    return importlib.import_module(f"{__package__}.reference.{fmt}")


def file_job(fmt, path, planes, quality):
    """In a worker: reference/<fmt>.py's check of the file at `path`
    against `planes`."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        data = b""                           # missing: every block is bad
    return file_format(fmt).check_file(data, planes, quality)


def file_sample(answers, seed, n) -> set:
    """Indices of at most n answers with a thumbnail file, drawn from the
    seed."""
    idx = [i for i, a in enumerate(answers) if a.file]
    if len(idx) <= n:
        return set(idx)
    return {int(i) for i in inputs.rng(seed, 4).choice(idx, size=n,
                                                        replace=False)}


def compare(driver, failed, file_checks):
    """(the numbers of this module's docstring, each {"value", "limit"};
    what they were counted from) for the driver's sampled answers."""
    from .reference.decode import cropped, planes_sha256
    config, answers = driver.config, driver.answers
    stream = config["streams"][driver.stream_key]
    want, size = stream["libavcodec_sha256"], stream["display_size"]
    good, differing, untapped = {}, [], 0
    for i, a in enumerate(answers):
        if a.planes is None:
            untapped += 1
            continue
        planes = a.planes if a.cropped else cropped(a.planes, size)
        if planes_sha256(*planes) == want[a.picture]:
            good[i] = planes
        else:
            differing.append(f"{a.where}: picture {a.picture}")
    numbers = {"answers_wrong": failed + len(differing) + untapped}
    parts = {"answers_failed": failed, "pictures_compared": len(answers),
             "pictures_differing": len(differing),
             "first_differing": differing[:5],
             "pictures_untapped": untapped}
    th = config.get("thumbnailer")
    if th:
        fmt = file_format(th["format"])
        pick = sorted(file_sample(answers, driver.seed, file_checks))
        held = [i for i in pick if i in good]
        bad = fmt.blocks(*size) * (len(pick) - len(held))
        total = fmt.blocks(*size) * len(pick)
        if held:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(
                    max_workers=min(len(held), os.cpu_count() or 1),
                    mp_context=ctx) as ex:
                for c in ex.map(file_job, [th["format"]] * len(held),
                                [answers[i].file for i in held],
                                [good[i] for i in held],
                                [th["quality"]] * len(held)):
                    bad += c["bad_blocks"]
        numbers[fmt.NUMBER] = bad
        parts.update(files_checked=len(pick), files_held=len(held),
                     file_blocks=total)
    return ({k: {"value": int(v), "limit": 0} for k, v in numbers.items()},
            parts)

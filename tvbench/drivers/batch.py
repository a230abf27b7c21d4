"""parallel.batch_thumbnail on one card, closed loop: one call over all
the mix's files after another, each into a new directory with a new
manifest (batch_thumbnail skips clips that an old manifest marks done),
until the window has passed.  The window's end is the end of the last
call begun inside it, so the rate is the work of the window over all of
its time."""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from .. import inputs
from . import Answer, Driver, _span


class _Tap:
    """Wraps export.image.export_picture while the window runs: copies the
    planes of the thumbnails whose file names are in `names` (the
    harness's tap between the decode and the writer; everything else goes
    through untouched)."""

    def __init__(self):
        self.names, self.got, self.lock = set(), {}, threading.Lock()

    def __enter__(self):
        from minivideo_tpu_torch.export import image
        self.module, self.orig = image, image.export_picture

        def export_picture(path_base, fmt, y, cb, cr, quality=75, rgb=None):
            name = os.path.basename(path_base)
            if name in self.names:
                kept = [np.array(p) for p in (y, cb, cr)]
            out = self.orig(path_base, fmt, y, cb, cr, quality, rgb=rgb)
            if name in self.names:
                with self.lock:
                    self.got[name] = (kept, out)
            return out

        image.export_picture = export_picture
        return self

    def __exit__(self, *exc):
        self.module.export_picture = self.orig


class Batch(Driver):
    e2e = "thumbnails_per_s"

    def _call(self, files, outdir, timed=_span):
        from minivideo_tpu_torch.codecs import PictureFormat, \
            PictureRepartition
        from minivideo_tpu_torch.parallel import batch_thumbnail
        th = self.config["thumbnailer"]
        with timed("parallel.batch_thumbnail"):
            return batch_thumbnail(
                files, outdir, pictures_per_clip=th["pictures"],
                mode=PictureRepartition[th["mode"].upper()],
                fmt=PictureFormat[th["format"].upper()],
                quality=th["quality"],
                manifest_path=os.path.join(outdir, "manifest.jsonl"),
                device=self.devices[0])

    def setup(self, seconds):
        with self.timed("tvbench.write_files"):
            self.files = inputs.write_files(
                self.config, self.traffic, self.seed,
                os.path.join(self.tmp, "in"))
        self.paths = [p for p, _ in self.files]
        self.first = {os.path.basename(p).rsplit(".", 1)[0]: k
                      for p, k in self.files}
        n0 = self.launches()
        r = self._call(self.paths, os.path.join(self.tmp, "warmup"),
                       self.timed)
        n1 = self.launches()
        self.notes.update(warmup_done=r.done, warmup_failed=r.failed,
                          warmup_launches_by_device={
                              str(k): n1.get(k, 0) - n0.get(k, 0)
                              for k in n1})
        self.seconds = seconds

    def window(self):
        per_call = self.traffic["sampled_per_call"]
        ext = self.config["thumbnailer"]["format"]
        t0 = time.perf_counter()
        calls = done = 0
        n0 = self.launches()
        with _Tap() as tap:
            while calls == 0 or time.perf_counter() - t0 < self.seconds:
                names = inputs.rng(self.seed, 2, calls).choice(
                    sorted(self.first), size=per_call, replace=False)
                tap.names = {str(n) for n in names}
                outdir = os.path.join(self.tmp, f"out{calls:04d}")
                r = self._call(self.paths, outdir, self.timed)
                for n in names:
                    planes, file = tap.got.pop(str(n), (None, None))
                    self.answers.append(Answer(
                        self.first[str(n)], planes, True,
                        file=file or os.path.join(outdir, f"{n}.{ext}"),
                        where=f"call {calls} {n}"))
                done += r.done
                calls += 1
        n1 = self.launches()
        self.notes.update(calls=calls, launches_by_device={
            str(k): n1.get(k, 0) - n0.get(k, 0) for k in n1})
        self.pictures = done
        self.per_launch = len(self.paths)
        attempted = calls * len(self.paths)
        return {"attempted": attempted, "failed": attempted - done,
                "count": done}


DRIVER = Batch

"""The program's at-rate decode: bench.Bench.overlapped on the seeded
stream, one run over the whole window, closed loop, one batch dispatched
ahead, ended by the first batch to complete after the window's seconds
(no drain inside it)."""

from __future__ import annotations

import os
import time

from .. import inputs
from . import Answer, Driver, _span


class _WindowOver(Exception):
    """Raised by the pipeline's consume hook once the window has passed."""


class Pipeline(Driver):
    e2e = "pictures_per_s"

    def setup(self, seconds):
        from minivideo_tpu_torch import bench
        from minivideo_tpu_torch.settings import staging_mode
        t = self.traffic
        self.batch = t["batch"]
        self.order = inputs.rng(self.seed, 0).permutation(self.n_pictures)
        data = inputs.reorder(inputs.stream(self.config, self.stream_key),
                              self.order)
        w, h = self.size
        with self.timed("bench.prep_pictures"):
            self.prep = bench.prep_pictures(data)
        with self.timed("bench.Bench"):
            self.bench = bench.Bench(self.devices[0], w // 16, h // 16,
                                     self.batch, t["warmup_batches"][0], 1)
        self.notes.update(staging=staging_mode(), cpu_count=os.cpu_count(),
                          ring_sets=bench.RING,
                          ring_bytes=self.bench.ring.nbytes,
                          ring_alloc_s=self.bench.ring.alloc_s)
        done = []
        for n in t["warmup_batches"]:
            self.bench.iters = n
            done = []
            with self.timed("bench.Bench.overlapped"):
                self.bench.overlapped(self.prep,
                                      lambda i, p: done.append(
                                          time.perf_counter()))
            self.bench.check_waits()
        step = (done[-1] - done[1]) / (len(done) - 2)
        # sampled among the batches that surely complete in the window
        reach = max(1, int(0.7 * seconds / step))
        pick = inputs.rng(self.seed, 1).choice(
            reach, size=min(t["sampled_batches"], reach), replace=False)
        self.sampled = {int(i) for i in pick}
        self.seconds = seconds
        self.notes.update(batch_s_in_warmup=step,
                          sampled_batches=sorted(self.sampled))

    def window(self):
        """One run of the pipeline from the window's start, its batch
        count unbounded; the first batch to complete after `seconds` ends
        it (the consume hook raises), with the next batch in flight."""
        bench = self.bench
        bench.iters = 1 << 40
        kept, times = {}, []
        deadline = time.perf_counter() + self.seconds

        def consume(i, planes):
            now = time.perf_counter()
            times.append(now)
            if i in self.sampled:
                kept[i] = [p.copy() for p in planes]
            if now >= deadline:
                raise _WindowOver

        clear0 = len(bench.ring.clear_s)
        t0 = time.perf_counter()
        with self.timed("bench.Bench.overlapped"):
            try:
                bench.overlapped(self.prep, consume)
            except _WindowOver:
                pass
        self.spans["ring_clear"] = list(bench.ring.clear_s[clear0:])
        n = len(times)
        self.pictures = self.batch * n
        self.per_launch = self.batch
        self.notes["batches"] = n
        if n >= 4:
            m = n // 2
            self.notes["pictures_per_s_halves"] = [
                self.batch * (m + 1) / (times[m] - t0),
                self.batch * (n - m - 1) / (times[-1] - times[m])]
        for i, planes in sorted(kept.items()):
            for r in range(self.batch):
                self.answers.append(Answer(
                    int(self.order[r % len(self.order)]),
                    [p[r] for p in planes], False,
                    where=f"batch {i} row {r}"))
        return {"attempted": self.pictures, "failed": 0,
                "count": self.pictures}

    def close(self):
        with _span("bench.Bench.check_waits"):
            self.bench.check_waits()
        self.bench.close()
        del self.bench


DRIVER = Pipeline

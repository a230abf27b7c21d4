"""Checkpointed batch progress: a JSONL manifest of processed clips.

Port of minivideo_tpu/parallel/manifest.py (a copy; imports no torch).

The reference has no checkpoint/resume at all (SURVEY.md §5: decode jobs
are seconds long; its only robustness is tolerating 64 consecutive NALU
errors, h264.c:181-187).  At pod scale a 10k-clip thumbnail job needs:

  * per-clip failure isolation — one corrupt clip must not kill the batch
    (the analogue of the reference's jumpy_mp4/jumpy_riff resync layers);
  * resumability — restarting a preempted job skips clips already done.

A Manifest is an append-only JSONL file; each line is
{"clip": path, "status": "done"|"failed", ...}.  Appends are atomic at
line granularity (single write() of one line), which is enough for the
one-writer-per-host model (each host owns its shard of clips, so hosts
write distinct manifest files: manifest.<process_index>.jsonl).
"""

from __future__ import annotations

import json
import os
import time


class Manifest:
    def __init__(self, path: str):
        self.path = path
        self._done: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue          # torn tail line from a crash
                    self._done[rec["clip"]] = rec
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    # -- recording -----------------------------------------------------------

    def record(self, clip: str, status: str, **extra):
        rec = {"clip": clip, "status": status, "ts": time.time(), **extra}
        self._done[clip] = rec
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def done(self, clip: str, **extra):
        self.record(clip, "done", **extra)

    def failed(self, clip: str, error: str, **extra):
        self.record(clip, "failed", error=error, **extra)

    # -- resume --------------------------------------------------------------

    def is_done(self, clip: str) -> bool:
        return self._done.get(clip, {}).get("status") == "done"

    def pending(self, clips) -> list:
        """Clips not yet successfully processed (failures are retried)."""
        return [c for c in clips if not self.is_done(c)]

    def stats(self) -> dict:
        n_done = sum(1 for r in self._done.values()
                     if r["status"] == "done")
        n_failed = sum(1 for r in self._done.values()
                       if r["status"] == "failed")
        return {"done": n_done, "failed": n_failed}

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

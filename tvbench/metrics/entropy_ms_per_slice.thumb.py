"""Host ms of the entropy parse per slice in the traced window: the mean
of the program's batch.parse_slice spans (one a slice of a picture of a
bucket, on batch_thumbnail's pool, each under its batch.parse_picture),
read from the span recorder's last session
(minivideo_tpu_torch.profiling).  Prints on stderr the pictures parsed
by their count of slices."""

import json
import sys
from collections import Counter


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    recs = last() if last else []
    s = [r for r in recs if r.name == "batch.parse_slice"]
    if not s:
        return None
    per = Counter(r.parent for r in s)
    pictures = [r.id for r in recs if r.name == "batch.parse_picture"]
    print("tvbench entropy_slices: " + json.dumps({
        "slices": len(s), "pictures": len(pictures),
        "pictures_by_slices": dict(Counter(
            str(per.get(p, 0)) for p in pictures))}),
        file=sys.stderr, flush=True)
    return sum(r.ms for r in s) / len(s)

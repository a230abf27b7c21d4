"""Host ms of the transport stream walk of a file in the traced window:
the mean thread CPU time of the program's demux.ts spans (one a TS or
BDAV file walked, native or Python, on batch_thumbnail's pool), read
from the span recorder's last session (minivideo_tpu_torch.profiling).
CPU time, not wall time, as demux_ms_per_file.thumb.  Prints on stderr
what the walks counted: files by packet size, resyncs, null packets and
packets."""

import json
import sys
from collections import Counter


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r for r in last() if r.name == "demux.ts"] if last else []
    if not s:
        return None
    info = [getattr(r, "info", None) or {} for r in s]
    print("tvbench ts_demux: " + json.dumps({
        "files": len(s),
        "packet_size": dict(Counter(str(i.get("packet_size")) for i in info)),
        "resyncs": sum(i.get("resyncs", 0) for i in info),
        "files_resynced": sum(bool(i.get("resyncs")) for i in info),
        "null_packets": sum(i.get("nulls", 0) for i in info),
        "packets": sum(r.items for r in s),
        "bytes": sum(r.nbytes for r in s)}), file=sys.stderr, flush=True)
    return sum(r.cpu_ms for r in s) / len(s)

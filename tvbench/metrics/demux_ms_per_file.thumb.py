"""Host ms of the demux of a file in the traced window: the mean thread
CPU time of the program's batch.demux_file spans (container parse, IDR
selection, stream assembly and slice headers of one file, on
batch_thumbnail's pool), read from the span recorder's last session
(minivideo_tpu_torch.profiling).  CPU time, not wall time: a pool thread
waits for the interpreter lock inside the span, so its wall time reads
the pool's contention more than the demux's own cost."""


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r.cpu_ms for r in last() if r.name == "batch.demux_file"] if last \
        else []
    return sum(s) / len(s) if s else None

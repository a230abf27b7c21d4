"""Wall ms of the host stage's parse of a batch in the traced window: the
mean of the program's bench.parse_batch spans (from the submission of a
batch's slice tasks to the pool to the end of its last), read from the
span recorder's last session (minivideo_tpu_torch.profiling)."""


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r.ms for r in last() if r.name == "bench.parse_batch"] if last \
        else []
    return sum(s) / len(s) if s else None

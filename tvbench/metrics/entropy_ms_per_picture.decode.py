"""Host ms of the entropy parse per picture in the traced window: the
summed time of the program's bench.parse_slice spans (one a slice task
of the pipeline's pool) over the pictures they parsed, read from the
span recorder's last session (minivideo_tpu_torch.profiling)."""


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r for r in last() if r.name == "bench.parse_slice"] if last else []
    pictures = sum(r.items for r in s)
    return sum(r.ms for r in s) / pictures if pictures else None

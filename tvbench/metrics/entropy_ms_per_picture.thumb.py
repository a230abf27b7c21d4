"""Host ms of the entropy parse per picture in the traced window: the
mean of the program's batch.parse_picture spans (one a picture of a
bucket, on batch_thumbnail's pool), read from the span recorder's last
session (minivideo_tpu_torch.profiling)."""


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r.ms for r in last() if r.name == "batch.parse_picture"] if last \
        else []
    return sum(s) / len(s) if s else None

"""Host ms of the picture writer per thumbnail in the traced window: the
mean of the program's export.picture spans (export.image.export_picture,
one a file written, on batch_thumbnail's export pool), read from the
span recorder's last session (minivideo_tpu_torch.profiling)."""


def read(readings):
    from minivideo_tpu_torch import profiling
    last = getattr(profiling, "last_session", None)
    s = [r.ms for r in last() if r.name == "export.picture"] if last \
        else []
    return sum(s) / len(s) if s else None

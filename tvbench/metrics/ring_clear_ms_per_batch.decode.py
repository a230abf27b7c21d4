"""Mean ms of the pinned staging ring's clear per batch in the window: the
program's own host-clock counter, bench.StagingRing.clear_s."""


def read(readings):
    s = readings.spans.get("ring_clear")
    return 1e3 * sum(s) / len(s) if s else None

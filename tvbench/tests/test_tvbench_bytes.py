"""The wave kernel's byte count: geometry and batch alone."""

from tvbench.metrics import _roofline as R


def test_bytes_at_1080p():
    mb = 768 + 17 + 2 + 384
    assert R.MB_BYTES == mb == 1171
    n = 120 * 68
    assert R.wave_bytes(1920, 1088, 1) == n * mb == 9_555_360
    assert R.wave_bytes(1920, 1088, 16) == 152_885_760
    assert R.wave_bytes(1920, 1088, 64) == 611_543_040
    # smaller than the "device" staging layout's 177,570,048 B at B = 16
    assert R.wave_bytes(1920, 1088, 16) < 177_570_048


def test_roofline_share_reads_the_launches_it_saw():
    class Rd:
        trace = {"wave": (4, 4 * 1.3e-3)}
        kind = "NVIDIA H100 80GB HBM3"
        per_launch = 16
        size = (1920, 1088)
    share = R.share(Rd)
    assert abs(share - 100 * 152_885_760 / 3.35e12 / 1.3e-3) < 1e-9
    Rd.kind = "another card"
    assert R.share(Rd) is None
    Rd.kind, Rd.trace = "NVIDIA H100 80GB HBM3", {"wave": (0, 0.0)}
    assert R.share(Rd) is None

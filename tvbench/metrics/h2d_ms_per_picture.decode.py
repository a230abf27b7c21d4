"""Device ms of host-to-device copies per picture decoded in the traced
window (the staging copy to the card)."""

from tvbench.metrics._roofline import h2d_ms_per_picture as read  # noqa: F401

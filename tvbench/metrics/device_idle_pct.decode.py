"""The cards' idle share of the traced window (%): 100 less the union of
kernels, copies and memsets, the mean over the cards used."""

from tvbench.metrics._roofline import idle_pct as read  # noqa: F401

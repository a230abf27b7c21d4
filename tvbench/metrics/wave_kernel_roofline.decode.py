"""The wave kernel's share of its roofline (%): the least time one launch
could take at the card's peak bandwidth for the bytes of _roofline.py,
over the mean device time of the launches in the traced window."""

from tvbench.metrics._roofline import share as read  # noqa: F401

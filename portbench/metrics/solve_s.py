"""Seconds a solve, one caller back to back: the window over the solves
(host clock)."""
from portbench.readers import mean_wall as read  # noqa: F401

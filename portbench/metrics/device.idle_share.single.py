"""The device: percent of the profiled calls in which no operation ran
on the card (device trace)."""
from portbench.readers import idle_share as read  # noqa: F401

"""Instances solved over the card's busy time in the window, an unsolved
one in no rate (device trace of the whole window): the solutions a
second of the card's work buys, which host stalls between its
operations do not dilute."""
from portbench.readers import instances_per_device_s as read  # noqa: F401

"""Instances solved over the window, an unsolved one in no rate (host
clock): what a batch user pays for."""
from portbench.readers import instances_per_s as read  # noqa: F401

"""The 90th percentile of the batch walls in the window (host clock): a
batch is one caller's request, and every lane of it waits for the
slowest, so a straggling lane shows here."""
from portbench.readers import percentile_90 as read  # noqa: F401

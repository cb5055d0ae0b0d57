"""Layer `parallel.batched`: blocking reads of the card's values a batch
(spans `lp_batch.host_read`), averaged over the profiled calls."""
from portbench.spans import named, trees


def read(record):
    ts = trees(record, "lp_batch")
    if ts is None:
        return None
    return sum(len(named(t, "lp_batch.host_read")) for t in ts) / len(ts)

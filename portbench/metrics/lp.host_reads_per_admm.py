"""Layer `lp` (the host loop): blocking reads of the card's values
(`lp.host_read`) per ADMM iteration (`lp.admm`) over the profiled
solves."""
from portbench.spans import named, trees


def read(record):
    ts = trees(record, "lp")
    if ts is None:
        return None
    iters = sum(len(named(t, "lp.admm")) for t in ts)
    if not iters:
        return None
    return sum(len(named(t, "lp.host_read")) for t in ts) / iters

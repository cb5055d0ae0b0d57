"""Layer `lp` (the host loop): blocking reads of the card's values
(`lp.host_read`: the eager loop's stop test, a block's flag, the BB
search's and the stages' reads) per ADMM iteration (the `admm_iters`
noted on the `lp.solve` roots) over the profiled solves."""
from portbench.spans import admm_iters, named, trees


def read(record):
    ts = trees(record, "lp")
    if ts is None:
        return None
    iters = admm_iters(ts)
    if not iters:
        return None
    return sum(len(named(t, "lp.host_read")) for t in ts) / iters

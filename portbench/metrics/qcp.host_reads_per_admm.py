"""Layer `qcp` (the host conic loop): blocking reads of the card's
values (`qcp.host_read`: the PCG's stop test, the inner criterion, the
residual checks and the answer's read) per ADMM iteration (the
`admm_iters` noted on the `qcp.solve` roots) over the profiled
solves."""
from portbench.spans import admm_iters, named, trees


def read(record):
    ts = trees(record, "qcp")
    if ts is None:
        return None
    iters = admm_iters(ts)
    if not iters:
        return None
    return sum(len(named(t, "qcp.host_read")) for t in ts) / iters

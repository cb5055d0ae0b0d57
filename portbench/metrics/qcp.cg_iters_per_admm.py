"""Layer `qcp` (the host conic loop): iterations of the Schur PCG (the
`cg_iters` noted on the `qcp.solve` roots, the setup's solve included)
per ADMM iteration (their `admm_iters`) over the profiled solves."""
from portbench.spans import admm_iters, trees


def read(record):
    ts = trees(record, "qcp")
    if ts is None:
        return None
    iters = admm_iters(ts)
    if not iters or any("cg_iters" not in t[0].attrs for t in ts):
        return None
    return sum(t[0].attrs["cg_iters"] for t in ts) / iters

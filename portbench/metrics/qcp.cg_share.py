"""Layer `qcp` (the host conic loop): percent of the profiled solves
(`qcp.solve`) spent in the Schur PCG (`qcp.cg`, one solve of the block
system each)."""
from portbench.spans import named, seconds, trees


def read(record):
    ts = trees(record, "qcp")
    if ts is None:
        return None
    pcg = seconds(s for t in ts for s in named(t, "qcp.cg"))
    return 100.0 * pcg / seconds(t[0] for t in ts)

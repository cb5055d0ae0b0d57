"""Layer `lp` (the host loop): mean host time to issue one ADMM
iteration over the profiled solves: an `lp.admm` span less the
`lp.host_read` spans under it, in us."""
from portbench.spans import named, seconds, trees


def read(record):
    ts = trees(record, "lp")
    if ts is None:
        return None
    total, count = 0.0, 0
    for t in ts:
        by_id = {s.span_id: s for s in t}
        iters = named(t, "lp.admm")
        total += seconds(iters)
        count += len(iters)
        for r in named(t, "lp.host_read"):
            up = by_id.get(r.parent_id)
            while up is not None and up.name != "lp.admm":
                up = by_id.get(up.parent_id)
            if up is not None:
                total -= seconds([r])
    if not count:
        return None
    return 1e6 * total / count

"""Layer `lp` (the host loop): percent of the profiled solves' ADMM
iterations (the `admm_iters` noted on the `lp.solve` roots) run in
blocks (the `iters` noted on `lp.admm_block` spans, each a CUDA graph's
replay on the card).  Blocks run only on a card: a CPU run reads 0."""
from portbench.spans import admm_iters, named, trees

CARD_ONLY = True


def read(record):
    ts = trees(record, "lp")
    if ts is None:
        return None
    iters = admm_iters(ts)
    if not iters:
        return None
    blocks = sum(s.attrs["iters"] for t in ts
                 for s in named(t, "lp.admm_block"))
    return 100.0 * blocks / iters

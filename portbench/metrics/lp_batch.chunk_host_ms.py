"""Layer `parallel.batched`: mean host time of a delta chunk
(`lp_batch.chunk`: the f64 anchor, the K1 launch, the state rebuilt from
the deltas and the f64 check) over the profiled calls, in ms."""
from portbench.spans import named, seconds, trees


def read(record):
    ts = trees(record, "lp_batch")
    if ts is None:
        return None
    chunks = [s for t in ts for s in named(t, "lp_batch.chunk")]
    if not chunks:
        return None
    return 1e3 * seconds(chunks) / len(chunks)

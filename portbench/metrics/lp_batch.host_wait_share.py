"""Layer `parallel.batched`: percent of the profiled calls
(`lp_batch.solve`) the host spends waiting on blocking reads of the
card's values (`lp_batch.host_read`)."""
from portbench.spans import share


def read(record):
    return share("lp_batch", record)

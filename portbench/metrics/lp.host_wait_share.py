"""Layer `lp` (the host loop): percent of the profiled solves
(`lp.solve`) the host spends waiting on blocking reads of the card's
values (`lp.host_read`)."""
from portbench.spans import share


def read(record):
    return share("lp", record)

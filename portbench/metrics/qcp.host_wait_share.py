"""Layer `qcp` (the host conic loop): percent of the profiled solves
(`qcp.solve`) the host spends waiting on blocking reads of the card's
values (`qcp.host_read`)."""
from portbench.spans import share


def read(record):
    return share("qcp", record)

"""95th percentile of the host-clock ms from the entry's call to its result on
the host, over every request completed in the window."""
from benchmark import readers


def read(run):
    return readers.latency_p95_ms(run)

"""K1 at the cell's sample batch: least time of its work over its device time in the trace, %."""
from benchmark import readers


def read(run):
    return readers.ar_decode_roofline_pct(run)

"""K1, the AR decode kernel: least time of its work (from the prior's widths)
over its device time in the trace, %."""
from benchmark import readers


def read(run):
    return readers.ar_decode_roofline_pct(run)

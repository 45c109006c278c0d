"""Share of the profiled wall time covered by no kernel, copy or fill, %."""
from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)

"""Model FLOPs of the window's completed requests over the window at the bf16 dense peak, %."""
from benchmark import readers


def read(run):
    return readers.generate_mfu_pct(run, with_face=True)

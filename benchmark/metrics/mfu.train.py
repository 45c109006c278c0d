"""Model FLOPs (forward and backward) of the window's steps over the window at
the bf16 dense peak, %."""
from benchmark import readers


def read(run):
    return readers.train_mfu_pct(run)

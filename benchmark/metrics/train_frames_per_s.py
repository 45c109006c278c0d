"""Training frames (batch x window) of the window's steps per second of the
window, closed by a synchronize."""
from benchmark import readers


def read(run):
    return readers.train_rate(run)

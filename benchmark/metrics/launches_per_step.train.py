"""Kernel launches per training step in the profiled part of the window (device trace)."""
from benchmark import readers


def read(run):
    return readers.launches_per_step(run)

"""Seconds of motion generated (samples x clip seconds of each completed
request) per second of the window."""
from benchmark import readers


def read(run):
    return readers.motion_rate(run)

"""The host's own ms per training step: the program's `train_step` spans minus
the `device_wait` spans under them."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("train_step")

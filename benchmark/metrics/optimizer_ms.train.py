"""The optimizer's host ms per training step: the program's `optimizer` spans
minus their `device_wait` children."""
from benchmark import program_trace


def read(run):
    return program_trace.optimizer_ms("train_step")

"""Host syncs per training step: the program's `host_sync` counter charged to
its `train_step` roots."""
from benchmark import program_trace


def read(run):
    return program_trace.host_syncs("train_step")

"""Host syncs per request: the program's `host_sync` counter (reads from the
card, copies to it) charged to its `generate` roots."""
from benchmark import program_trace


def read(run):
    return program_trace.host_syncs("generate")

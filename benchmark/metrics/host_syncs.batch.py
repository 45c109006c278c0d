"""Host syncs per request: the program's `host_sync` counter charged to its
`mfcc` and `body_stage` roots, per `body_stage`."""
from benchmark import program_trace


def read(run):
    return program_trace.host_syncs("body_stage")

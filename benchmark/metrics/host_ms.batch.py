"""The host's own ms per request: the program's `mfcc` and `body_stage` spans
minus their `device_wait` spans, per `body_stage`."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("body_stage")

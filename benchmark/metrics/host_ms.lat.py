"""The host's own ms per request: the program's `generate` spans minus the
`device_wait` spans under them."""
from benchmark import program_trace


def read(run):
    return program_trace.host_ms("generate")

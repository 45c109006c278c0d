"""Assembly (Pipeline.assemble_full, ops/pose.part2full on the host): ms per
request, CUDA events."""
from benchmark import readers


def read(run):
    return readers.span_ms(run, "assembly")

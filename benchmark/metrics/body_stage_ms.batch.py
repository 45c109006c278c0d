"""Body stage (Pipeline.generate_body at the cell's sample batch): ms per request, CUDA events."""
from benchmark import readers


def read(run):
    return readers.span_ms(run, "body_stage")

"""Body stage (Pipeline.generate_body: audio encoder, K1, VQ decoders,
readback): ms per request, CUDA events."""
from benchmark import readers


def read(run):
    return readers.span_ms(run, "body_stage")

"""Face stage (Pipeline.generate_face: K3, K2, the conv heads, readback): ms
per request, CUDA events."""
from benchmark import readers


def read(run):
    return readers.span_ms(run, "face_stage")

"""Audio front end (ops/audio.get_mfcc): ms per request, CUDA events."""
from benchmark import readers


def read(run):
    return readers.span_ms(run, "mfcc")

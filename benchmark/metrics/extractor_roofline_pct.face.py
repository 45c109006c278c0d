"""K3 in its LayerNorm mode (WavLM's conv extractor): least time of the
profiled requests' extractor passes (`wavlm_counts`) over K3's device time
in the trace, %."""
from benchmark import face_readers


def read(run):
    return face_readers.roofline_pct(run, "extractor")

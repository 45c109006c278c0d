"""K2 in its pre-norm mode (WavLM's layer stack with the gated bias): least
time of the profiled requests' encoder passes (`wavlm_counts`, bytes or
FLOPs, whichever binds) over K2's device time in the trace, %."""
from benchmark import face_readers


def read(run):
    return face_readers.roofline_pct(run, "encoder")

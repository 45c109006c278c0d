"""The WavLM face's model FLOPs (FlopCounterMode over `reference/wavlm.py`)
of the window's completed requests over the window at the bf16 dense peak, %."""
from benchmark import face_readers


def read(run):
    return face_readers.face_mfu_pct(run)

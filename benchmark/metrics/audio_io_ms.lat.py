"""Reading and resampling the wav, ms per request: the program's `wav_read` and
`resample` spans under its `generate` roots."""
from benchmark import program_trace


def read(run):
    return program_trace.audio_io_ms("generate")

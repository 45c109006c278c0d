"""Hand-written CUDA kernels of the port and their launch counts.

Nothing here touches CUDA, nvcc or triton at import time: each kernel's
shared library is built and loaded on first launch (`_build.py`).

`counts` maps a name to the number of times it ran in this process: each
kernel wrapper adds one where it launches its kernel (e.g.
``counts["ar_decode"]``), and the plain PyTorch twin adds one under its
own name (``counts["sample_tokens_plain"]``), so a run can show which path
it took.  Reset it with ``counts.clear()``.
"""
from collections import Counter

counts: Counter = Counter()

"""Hand-written CUDA kernels of the port and their launch counts.

Nothing here touches CUDA, nvcc or triton at import time: each kernel's
shared library is built and loaded on first launch (`_build.py`).

`counts` maps a name to the number of times it ran in this process: each
kernel wrapper adds one where it launches its kernel (e.g.
``counts["ar_decode"]``), and the plain PyTorch twin adds one under its
own name (``counts["sample_tokens_plain"]``), so a run can show which path
it took.  Reset it with ``counts.clear()``.  It is `talkshow_torch.tracing.counts`,
the program's one counter, which also counts its host syncs and charges
each increment to the open root span while tracing records.

`TABLE_DTYPES` maps the weight-table types the kernels take to the code
their C entry points read, and `check` is the wrappers' argument check.
"""
import torch

from talkshow_torch.tracing import counts

TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check(name: str, t: torch.Tensor, shape, dtype: torch.dtype, device) -> None:
    """Raise unless t has this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

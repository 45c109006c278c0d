"""Kernel K4: the VQ nearest-code search.

Wrapper of `talkshow_torch/csrc/nearest_code.cu`, which replaces the TPU
kernel `talkshow_tpu/ops/vq.py:nearest_code_pallas` (:72, body
`_nearest_code_kernel` :62-68): rows x (N, D) f32 against a codebook
(K, D) f32 -> argmin_k(-2 x.e_k + ||e_k||^2) as (N,) int64, the lowest
index winning a tie.  What bounds it on the card and what the design does
about it are set out at the top of the CUDA source.

Both versions compute the same f32 expression, -2 * (x @ E^T) + ||e||^2
(not ||x - e||^2), the kernel with FMAs in depth order and no TF32, so they
agree up to summation order: indices can differ only on rows whose two best
distances lie within a few ulps.

A CUDA tensor launches the kernel (`nearest_code_kernel`, one launch adds
one to ``counts["nearest_code"]``) or raises; the plain version
(``counts["nearest_code_plain"]``) is for CPU tensors and for comparison.
`ops.vq.nearest_code` picks between them by the tensor's device.  Neither
needs a gradient: the indices only feed a gather whose gradient is stopped.
"""
from __future__ import annotations

import ctypes

import torch

from talkshow_torch.kernels import check, counts

SOURCE = "talkshow_torch/csrc/nearest_code.cu"
REPLACES = "talkshow_tpu/ops/vq.py:72"

#: widest code vector the CUDA code takes
MAX_DIM = 64

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("nearest_code")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_nearest_code.argtypes = [_I] * 3 + [_P] * 6
        lib.talkshow_nearest_code.restype = _I
        lib._talkshow_typed = True
    return lib


def code_norms(embeddings: torch.Tensor) -> torch.Tensor:
    """||e_k||^2 per code, (K,) f32 (computed outside the kernel, as JAX does
    at ops/vq.py:84)."""
    return (embeddings * embeddings).sum(dim=1)


@torch.no_grad()
def nearest_code_plain(flat_x: torch.Tensor, embeddings: torch.Tensor,
                       e2: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (the twin of ops/vq.py:nearest_code_xla)."""
    counts["nearest_code_plain"] += 1
    if e2 is None:
        e2 = code_norms(embeddings)
    dist = -2.0 * (flat_x @ embeddings.T) + e2[None, :]
    return torch.argmin(dist, dim=1)


@torch.no_grad()
def nearest_code_kernel(flat_x: torch.Tensor, embeddings: torch.Tensor,
                        e2: torch.Tensor | None = None) -> torch.Tensor:
    """K4 on the card: (N, D) and (K, D) f32 CUDA tensors -> (N,) int64."""
    if flat_x.device.type != "cuda":
        raise ValueError(f"nearest_code runs on CUDA tensors, not {flat_x.device}")
    dev = flat_x.device
    N, D = flat_x.shape
    K = embeddings.shape[0]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"the kernel takes code vectors of 1 to {MAX_DIM} values, not {D}")
    if e2 is None:
        e2 = code_norms(embeddings)
    check("flat_x", flat_x, (N, D), torch.float32, dev)
    check("embeddings", embeddings, (K, D), torch.float32, dev)
    check("e2", e2, (K,), torch.float32, dev)
    idx = torch.empty((N,), dtype=torch.int64, device=dev)
    if N == 0:
        return idx
    keys = torch.empty((N,), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.talkshow_nearest_code(N, K, D, flat_x.data_ptr(), embeddings.data_ptr(),
                                        e2.data_ptr(), keys.data_ptr(), idx.data_ptr(),
                                        stream)
    if err != 0:
        raise RuntimeError(f"nearest_code launch failed: cudaError_t {err}")
    counts["nearest_code"] += 1
    return idx

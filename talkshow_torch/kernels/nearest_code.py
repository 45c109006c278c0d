"""Kernel K4: the VQ nearest-code search.

Wrapper of `talkshow_torch/csrc/nearest_code.cu`, which replaces the TPU
kernel `talkshow_tpu/ops/vq.py:nearest_code_pallas` (:72, body
`_nearest_code_kernel` :62-68): rows x (N, D) f32 against a codebook
(K, D) f32 -> argmin_k(-2 x.e_k + ||e_k||^2) as (N,) int64, the lowest
index winning a tie.  What bounds it on the card and what the design does
about it are set out at the top of the CUDA source; `search_plan` is the
host's half of it, the shape of the grid.

Both versions compute the same f32 expression, -2 * (x @ E^T) + ||e||^2
(not ||x - e||^2), the kernel with FMAs in depth order and no TF32, and
||e||^2 as its own FMA chain, so they agree up to summation order: indices
can differ only on rows whose two best distances lie within a few ulps.

A CUDA tensor launches the kernel (`nearest_code_kernel`, one launch adds
one to ``counts["nearest_code"]``) or raises; the plain version
(``counts["nearest_code_plain"]``) is for CPU tensors and for comparison.
`ops.vq.nearest_code` picks between them by the tensor's device.  Neither
needs a gradient: the indices only feed a gather whose gradient is stopped.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from talkshow_torch.kernels import check, counts

SOURCE = "talkshow_torch/csrc/nearest_code.cu"
REPLACES = "talkshow_tpu/ops/vq.py:72"

#: widest code vector the CUDA code takes
MAX_DIM = 64
#: most CTAs in a cluster (16 is the card's non-portable limit)
MAX_CLUSTER = 16
#: the kernel's two tile shapes (`Tile` in the CUDA source), by variant:
#: x rows per tile, codes a CTA holds at once, warps across the codes
TILES = ((64, 256, 2), (8, 128, 8))
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132

_P, _I = ctypes.c_void_p, ctypes.c_int


class SearchPlan(NamedTuple):
    variant: int    # index into TILES
    rows: int       # x rows per tile (one cluster per tile)
    cluster: int    # CTAs per cluster, each one code slice
    slice: int      # codes per CTA; the last CTA's may be shorter, none is empty
    passes: int     # shared-memory fills per CTA
    ctas: int       # the grid
    smem: int       # dynamic shared memory per CTA, bytes


def tile_plan(N: int, K: int, D: int, variant: int, passes: int = 1) -> SearchPlan:
    """The grid of one search in TILES[variant]: the codebook split into as
    few slices of at most `passes` shared-memory fills as MAX_CLUSTER
    allows, one CTA each, for every tile of rows."""
    rows, codes, warps = TILES[variant]
    slice_ = -(-K // min(MAX_CLUSTER, -(-K // (codes * passes))))
    cluster = -(-K // slice_)
    groups = -(-D // 16)                  # TMA boxes of 16 depth values, 64-byte rows
    row_box = -(-rows * 64 // 1024) * 1024
    smem = (1024 + groups * (codes * 64 + row_box) + codes * 4
            + MAX_CLUSTER * warps * rows * 8 + groups * 8)
    return SearchPlan(variant, rows, cluster, slice_, -(-slice_ // codes),
                      -(-N // rows) * cluster, smem)


@functools.lru_cache(maxsize=256)
def search_plan(N: int, K: int, D: int, sms: int = H100_SMS) -> SearchPlan:
    """8-row tiles where their whole grid is resident at once (two CTAs an
    SM), else 64-row tiles; and those with two passes over twice the codes
    a CTA where one pass's grid would not be resident at once
    (chip_smoke.py phase 12 times the choices at N = 75, 300 and 2816)."""
    narrow = tile_plan(N, K, D, 1)
    if narrow.ctas <= 2 * sms:
        return narrow
    wide = tile_plan(N, K, D, 0)
    return wide if wide.ctas <= 2 * sms else tile_plan(N, K, D, 0, passes=2)


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("nearest_code")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_nearest_code.argtypes = [_I] * 6 + [_P] * 3 + [_I, _P]
        lib.talkshow_nearest_code.restype = _I
        lib._talkshow_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def code_norms(embeddings: torch.Tensor) -> torch.Tensor:
    """||e_k||^2 per code, (K,) f32 (as JAX computes it at ops/vq.py:84)."""
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


def nearest_code_kernel(flat_x: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
    """K4 on the card: (N, D) and (K, D) contiguous f32 CUDA tensors ->
    (N,) int64, in one launch (||e_k||^2 computed inside)."""
    if flat_x.device.type != "cuda":
        raise ValueError(f"nearest_code runs on CUDA tensors, not {flat_x.device}")
    dev = flat_x.device
    N, D = flat_x.shape
    K = embeddings.shape[0]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"the kernel takes code vectors of 1 to {MAX_DIM} values, not {D}")
    check("flat_x", flat_x, (N, D), torch.float32, dev)
    check("embeddings", embeddings, (K, D), torch.float32, dev)
    idx = torch.empty((N,), dtype=torch.int64, device=dev)
    if N == 0:
        return idx
    plan = search_plan(N, K, D, _sms(dev.index))
    # TMA reads rows of a multiple of 16 bytes from 16-byte aligned bases:
    # other shapes and views get a zero-padded copy (zeros add nothing to a dot)
    if D % 4 or flat_x.data_ptr() % 16 or embeddings.data_ptr() % 16:
        flat_x, embeddings = (F.pad(t, (0, -D % 4)) for t in (flat_x, embeddings))
        D = flat_x.shape[1]
    # the raw current stream: what torch.cuda.current_stream(dev).cuda_stream
    # returns, without building a Stream object on every call
    err = _lib().talkshow_nearest_code(N, K, D, plan.variant, plan.cluster, plan.slice,
                                       flat_x.data_ptr(), embeddings.data_ptr(), idx.data_ptr(),
                                       dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        what = (f"CUresult {err - 10000} encoding a tensor map" if err >= 10000
                else f"cudaError_t {err}")
        raise RuntimeError(f"nearest_code launch failed: {what} ({plan})")
    counts["nearest_code"] += 1
    return idx

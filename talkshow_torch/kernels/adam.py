"""The Adam steps' optimizer chain: `grad_stats` and `adam_apply`.

Wrapper of `talkshow_torch/csrc/adam.cu`, which replaces no TPU kernel:
the JAX steps run optax's `skip_nonfinite(chain(clip_by_global_norm, adam))`
as tree maps that XLA fuses into the step (talkshow_tpu/utils.py:75-114,
talkshow_tpu/train/steps.py:49,159-162).  Eager PyTorch ran that chain as
a few launches per leaf and two host reads (the finite flag, the clip's
norm); these are two multi-tensor passes and no host read.  What bounds
them and what the design does about it is set out at the top of the CUDA
source.

- `grad_stats(grads, workspace)` -> (stats, finite): stats (2,) f32 holds
  the sum of every gradient element's square and its square root, the
  global norm (optax.global_norm); finite a 0-dim bool, no element inf or
  nan.  The kernel sums in a fixed order, so two calls give the same bits.
- `adam_apply(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step,
  skipped, lr, max_norm, betas, eps, workspace)`: where `finite`, each
  gradient is clipped by optax's rule (`g if norm < max_norm else g / norm
  * max_norm`, when max_norm is not None) and Adam's update, as
  torch.optim.Adam computes it, written in place into the parameters and
  moments, `step` (0-dim f32, Adam's count) going up by one; else nothing
  of those is written and `skipped` (0-dim int64) goes up by one.  The
  gradients are left as they are.

Both dispatch by the tensors' device: CUDA tensors launch the kernel (one
launch per `capacity` leaves; ``counts["grad_stats"]``,
``counts["adam_apply"]``) or raise, CPU tensors take the plain version
(``counts["grad_stats_plain"]``, ``counts["adam_apply_plain"]``), which is
the arithmetic of the kernel in PyTorch operations, with no host branch.
The kernel's element arithmetic is the plain version's with each rounding
explicit; its sum of squares runs in another order (a few f32 ulps).

`workspace(n, device)` is the kernels' scratch for lists of up to n leaves
(zero-filled; every call leaves it so).  Calls that share one run on one
stream at a time.  `leaf_rows` is the leaf table the kernels read, checked
tensor by tensor; a caller that steps the same leaves every step keeps the
parameters' and moments' rows and checks only the gradients'.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from talkshow_torch.kernels import counts

SOURCE = "talkshow_torch/csrc/adam.cu"
REPLACES = None

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("adam")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_adam_capacity.argtypes = [_I]
        lib.talkshow_adam_capacity.restype = _I
        lib.talkshow_adam_workspace_bytes.argtypes = [_I]
        lib.talkshow_adam_workspace_bytes.restype = ctypes.c_longlong
        lib.talkshow_grad_stats.argtypes = [_I] + [_P] * 5 + [_I, _P]
        lib.talkshow_grad_stats.restype = _I
        lib.talkshow_adam_apply.argtypes = [_I] + [_P] * 6 + [_D] * 5 + [_P, _I, _P]
        lib.talkshow_adam_apply.restype = _I
        lib._talkshow_typed = True
    return lib


def capacity() -> tuple[int, int]:
    """Leaves one launch of grad_stats and of adam_apply takes."""
    lib = _lib()
    return lib.talkshow_adam_capacity(0), lib.talkshow_adam_capacity(1)


def workspace(n: int, device) -> torch.Tensor:
    """The kernels' zero-filled scratch for lists of up to n leaves."""
    return torch.zeros(int(_lib().talkshow_adam_workspace_bytes(n)), dtype=torch.uint8,
                       device=device)


def leaf_rows(dev: torch.device, *columns) -> np.ndarray:
    """(leaves, len(columns) + 1) int64: each leaf's data pointers, one per
    column, and its element count; raises unless every tensor is f32,
    contiguous, on dev and the size of its row's first."""
    rows = []
    for ts in zip(*columns):
        n = ts[0].numel()
        for t in ts:
            if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous() \
                    or t.numel() != n:
                raise ValueError(f"the Adam kernels take contiguous f32 tensors on {dev} of "
                                 f"one size a leaf, not {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
        rows.append([t.data_ptr() for t in ts] + [n])
    return np.asarray(rows, dtype=np.int64).reshape(len(rows), len(columns) + 1)


def _check_work(ws: torch.Tensor, n: int, dev: torch.device) -> None:
    need = int(_lib().talkshow_adam_workspace_bytes(n))
    if ws is None or ws.dtype != torch.uint8 or ws.device != dev or ws.numel() < need:
        raise ValueError(f"the Adam kernels need a workspace(n={n}) on {dev}")


def _launched(name: str, err: int, launches: ctypes.c_int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    counts[name] += launches.value


@torch.no_grad()
def grad_stats_plain(grads: list, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of grad_stats (the arithmetic of optim's
    global_norm and all_finite, with no host read)."""
    counts["grad_stats_plain"] += 1
    device = grads[0].device if grads else device
    sq = sum((torch.sum(g * g) for g in grads), torch.zeros((), device=device))
    finite = (torch.stack([torch.isfinite(g).all() for g in grads]).all() if grads
              else torch.ones((), dtype=torch.bool, device=device))
    return torch.stack([sq, torch.sqrt(sq)]), finite


def grad_stats_kernel(grads: list, work: torch.Tensor, device=None,
                      rows: np.ndarray | None = None):
    """grad_stats on the card: f32 CUDA gradients, one launch per
    `capacity()[0]` of them (one at least).  `rows`: `leaf_rows(device,
    grads)`, where the caller has them already."""
    dev = torch.device(grads[0].device if grads else device)
    if dev.type != "cuda":
        raise ValueError(f"grad_stats runs on CUDA tensors, not {dev}")
    table = leaf_rows(dev, grads) if rows is None else rows
    if table.shape != (len(grads), 2):
        raise ValueError("grad_stats: a row a gradient")
    _check_work(work, len(grads), dev)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    launches = ctypes.c_int(0)
    err = _lib().talkshow_grad_stats(len(grads), table.ctypes.data, work.data_ptr(),
                                     stats.data_ptr(), finite.data_ptr(), ctypes.byref(launches),
                                     dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    _launched("grad_stats", err, launches)
    return stats, finite


def grad_stats(grads: list, work: torch.Tensor | None = None, device=None,
               rows: np.ndarray | None = None):
    """(stats, finite) of the gradients (see the module doc); `device` for
    an empty list, `rows` as grad_stats_kernel takes them."""
    dev = torch.device(grads[0].device if grads else device)
    if dev.type == "cuda":
        return grad_stats_kernel(grads, work, dev, rows)
    return grad_stats_plain(grads, dev)


@torch.no_grad()
def adam_apply_plain(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step, skipped,
                     lr: float, max_norm: float | None, betas=(0.9, 0.999),
                     eps: float = 1e-8) -> None:
    """Plain PyTorch version of adam_apply: torch.optim.Adam's single-tensor
    arithmetic with the bias corrections taken in f64 from the device step
    count, every write a select on `finite`."""
    counts["adam_apply_plain"] += 1
    b1, b2 = betas
    norm = stats[1]
    t = step + 1
    neg_step_size = -(lr / (1 - torch.pow(b1, t.double())))
    bc2_sqrt = torch.sqrt(1 - torch.pow(b2, t.double()))
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if max_norm is not None:
            g = torch.where(norm < max_norm, g, g / norm * max_norm)
        m_new = torch.lerp(m, g, 1 - b1)
        v_new = torch.addcmul(v * b2, g, g, value=1 - b2)
        denom = (v_new.sqrt() / bc2_sqrt).add_(eps)
        p_new = torch.addcdiv(p, m_new * neg_step_size, denom)
        for old, new in ((p, p_new), (m, m_new), (v, v_new)):
            torch.where(finite, new, old, out=old)
    torch.where(finite, t, step, out=step)
    skipped.add_((~finite).to(skipped.dtype))


def adam_apply_kernel(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step, skipped,
                      lr: float, max_norm: float | None, betas=(0.9, 0.999),
                      eps: float = 1e-8, work: torch.Tensor | None = None,
                      rows: np.ndarray | None = None) -> None:
    """adam_apply on the card: every tensor f32 (the counts excepted),
    contiguous, on one CUDA device; one launch per `capacity()[1]` leaves
    (one at least).  `rows`: `leaf_rows(device, params, grads, exp_avgs,
    exp_avg_sqs)`, where the caller has them already."""
    dev = step.device
    if dev.type != "cuda":
        raise ValueError(f"adam_apply runs on CUDA tensors, not {dev}")
    table = leaf_rows(dev, params, grads, exp_avgs, exp_avg_sqs) if rows is None else rows
    if table.shape != (len(params), 5):
        raise ValueError("adam_apply: one gradient and two moments a parameter")
    _check_work(work, len(params), dev)
    for name, t, dtype, n in (("stats", stats, torch.float32, 2), ("finite", finite, torch.bool, 1),
                              ("step", step, torch.float32, 1),
                              ("skipped", skipped, torch.int64, 1)):
        if t.dtype != dtype or t.device != dev or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"adam_apply: {name} must be {n} {dtype} on {dev}")
    launches = ctypes.c_int(0)
    err = _lib().talkshow_adam_apply(
        len(params), table.ctypes.data, work.data_ptr(), stats.data_ptr() + 4,
        finite.data_ptr(), step.data_ptr(), skipped.data_ptr(), float(lr),
        -1.0 if max_norm is None else float(max_norm), float(betas[0]), float(betas[1]),
        float(eps), ctypes.byref(launches), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _launched("adam_apply", err, launches)


def adam_apply(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step, skipped,
               lr: float, max_norm: float | None, betas=(0.9, 0.999), eps: float = 1e-8,
               work: torch.Tensor | None = None, rows: np.ndarray | None = None) -> None:
    """One Adam step over the leaves unless `finite` is false (see the
    module doc); `rows` as adam_apply_kernel takes them."""
    if step.device.type == "cuda":
        adam_apply_kernel(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step, skipped,
                          lr, max_norm, betas, eps, work, rows)
    else:
        adam_apply_plain(params, grads, exp_avgs, exp_avg_sqs, stats, finite, step, skipped,
                         lr, max_norm, betas, eps)

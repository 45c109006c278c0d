"""Runtime utilities (port of talkshow_tpu/utils.py): profiling,
seeding, parameter casting and the trainer's batch prefetch.

  * `trace(log_dir)`: torch.profiler around a block, written as a Chrome
    trace under log_dir (the card's kernels included when it runs there).
    The profiler turns on the program's own spans (`talkshow_torch.tracing`:
    ``span:generate``, ``span:device_wait``, ``span:optimizer``, ...), so
    the trace names its phases beside the kernels; `tracing.span(name)`
    names a region of the caller's own;
  * `seed_everything(seed)` -> (numpy Generator, torch Generator);
  * `cast_floats`: cast a module's or a state dict's float tensors,
    normalisation tensors kept f32;
  * `prefetch_iter`: the trainer's background batch producer
    (train/trainer.py), re-exported.

The JAX module's optax wrapper `skip_nonfinite_updates` is
`train/optim.SkipNonfinite` here.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from talkshow_torch.train.trainer import prefetch_iter

__all__ = ["trace", "seed_everything", "cast_floats", "prefetch_iter"]


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block with torch.profiler (CPU, and CUDA when a card is
    present) and write `trace.json` (Chrome trace format) under log_dir.
    Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def seed_everything(seed: int) -> tuple[np.random.Generator, torch.Generator]:
    """-> (np.random.Generator, torch.Generator), both seeded with `seed`;
    no global state changes."""
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)


def _is_norm(name: str) -> bool:
    """A tensor of a normalisation layer: its module's name contains "norm"
    (the port keeps the reference's names: `norm`, `layer_norm`,
    `final_layer_norm`, the extractor's GroupNorm `layer_norm`), or it is a
    running statistic."""
    owner, _, leaf = name.rpartition(".")
    return "norm" in owner.rpartition(".")[2].lower() or leaf in ("running_mean", "running_var")


@torch.no_grad()
def cast_floats(obj, dtype: torch.dtype = torch.bfloat16, keep_norm_f32: bool = True):
    """Cast the float tensors of a module (in place; returns it) or of a
    state dict (returns a new dict) to `dtype` (inference quantization).

    With keep_norm_f32 the tensors of normalisation layers (scales, biases,
    running statistics) stay f32, as JAX keeps the BatchNorms and the norm
    scales (talkshow_tpu/utils.py:117-129; JAX matches flax names, so it
    also casts the biases of its LayerNorms, whose names lack "Norm").
    Integer tensors are left alone.

    A cast state dict loaded into an f32 module (`load_state_dict` copies
    with conversion) computes in f32 on the rounded weights, which is what
    flax does with cast parameters (it promotes bf16 x f32 to f32); that is
    how the generate path runs a cast prior and audio encoder."""
    def cast(name, t):
        if not t.is_floating_point() or (keep_norm_f32 and _is_norm(name)):
            return t
        return t.to(dtype)

    if isinstance(obj, torch.nn.Module):
        for name, t in list(obj.named_parameters()) + list(obj.named_buffers()):
            t.data = cast(name, t.data)
        return obj
    return {k: cast(k, v) if torch.is_tensor(v) else v for k, v in obj.items()}

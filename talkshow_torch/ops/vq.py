"""EMA vector quantization: codebook state, nearest-code search, lookup and
the training update (port of talkshow_tpu/ops/vq.py:30-48,101-165).

Semantics of the reference VectorQuantizerEMA (nets/spg/vqvae_modules.py:
244-323): L2 nearest-code lookup, straight-through estimator, commitment
loss (beta 0.25), debiased EMA codebook updates with Laplace-smoothed
cluster sizes.  The codebook state is an explicit `VQState` threaded
through the train step, as in the JAX package.

`nearest_code` launches K4 (`kernels/nearest_code.py`) on a CUDA tensor and
runs its plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from talkshow_torch.kernels.nearest_code import nearest_code_kernel, nearest_code_plain

__all__ = ["VQState", "init_vq_state", "nearest_code", "nearest_code_plain", "quantize",
           "quantize_train", "lookup"]


class VQState(NamedTuple):
    """EMA codebook state (one per quantizer)."""
    embeddings: torch.Tensor        # (K, D)
    ema_dw_hidden: torch.Tensor     # (K, D)
    ema_count_hidden: torch.Tensor  # (K,)
    counter: torch.Tensor           # () int32

    def to(self, device) -> "VQState":
        return VQState(*(t.to(device) for t in self))


def init_vq_state(generator: torch.Generator, num_embeddings: int,
                  embedding_dim: int, device="cuda") -> VQState:
    """xavier-uniform codebook, zero EMA statistics."""
    limit = (6.0 / (num_embeddings + embedding_dim)) ** 0.5
    emb = torch.rand((num_embeddings, embedding_dim), generator=generator)
    emb = (emb * 2.0 - 1.0) * limit
    return VQState(emb, torch.zeros_like(emb),
                   torch.zeros((num_embeddings,)),
                   torch.zeros((), dtype=torch.int32)).to(device)


def nearest_code(flat_x: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - e_k||^2 over (N, D) x (K, D) -> (N,) int64: K4 on a
    CUDA tensor (one launch), the plain version on a CPU tensor."""
    if flat_x.device.type == "cuda":
        return nearest_code_kernel(flat_x.contiguous(), embeddings.contiguous())
    return nearest_code_plain(flat_x, embeddings)


def quantize(state: VQState, z: torch.Tensor):
    """Eval-mode quantization: z (..., D) -> (quantized, indices (...))."""
    flat = z.detach().reshape(-1, z.shape[-1])
    idx = nearest_code(flat, state.embeddings)
    quant = state.embeddings[idx].reshape(z.shape)
    return quant, idx.reshape(z.shape[:-1])


def lookup(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """Codebook lookup: (...,) int -> (..., D)."""
    return state.embeddings[indices]


def quantize_train(state: VQState, z: torch.Tensor, commitment_cost: float = 0.25,
                   decay: float = 0.99, epsilon: float = 1e-5):
    """Training-mode quantization with straight-through + EMA update.

    z: (..., D) encoder output.  Returns (quantized_st, commit_loss,
    new_state, indices).  The EMA update runs on detached values, as the
    reference's torch.no_grad block (vqvae_modules.py:288-299).  The code
    sums dw = onehot^T @ flat are a matmul (TF32 off on the card), not an
    atomic scatter, so a rerun gives the same state bit for bit."""
    flat = z.detach().reshape(-1, z.shape[-1])
    k = state.embeddings.shape[0]
    idx = nearest_code(flat, state.embeddings)
    quant = state.embeddings[idx].reshape(z.shape)

    with torch.no_grad():
        onehot = F.one_hot(idx, k).to(flat.dtype)                   # (N, K)
        counts = onehot.sum(dim=0)                                 # (K,)
        dw = onehot.T @ flat                                       # (K, D)
        counter = state.counter + 1
        ema_count_hidden = state.ema_count_hidden - (state.ema_count_hidden - counts) * (1 - decay)
        ema_dw_hidden = state.ema_dw_hidden - (state.ema_dw_hidden - dw) * (1 - decay)
        debias = 1.0 - torch.pow(decay, counter.to(torch.float32))
        ema_count = ema_count_hidden / debias
        ema_dw = ema_dw_hidden / debias
        n_total = ema_count.sum()
        smoothed = (ema_count + epsilon) / (n_total + k * epsilon) * n_total
        new_state = VQState(ema_dw / smoothed[:, None], ema_dw_hidden, ema_count_hidden,
                            counter)

    commit = commitment_cost * torch.mean((z - quant.detach()) ** 2)
    quant_st = z + (quant - z).detach()
    return quant_st, commit, new_state, idx.reshape(z.shape[:-1])

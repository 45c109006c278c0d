"""VQ codebook state and lookup (talkshow_tpu/ops/vq.py:30-48,122-124).

Decoding needs only the codebook lookup.  The nearest-code search and the
EMA training update (and with them the TPU kernel `nearest_code_pallas`)
are not ported yet: see ROADMAP.md.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


def lookup(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """Codebook lookup: (...,) int -> (..., D)."""
    return state.embeddings[indices]

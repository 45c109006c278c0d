"""Random weights of the WavLM face generator (`talkshow-wavlm-large`),
drawn on the device from the seed under `weights.py`'s rules: one uniform
and one normal block on a `torch.Generator` of the device, matrices and
conv kernels xavier-uniform, embedding tables (the relative-position table
`rel_attn_embed`) standard normal, biases uniform on (-0.1, 0.1), norm
scales and other vectors 1 plus that.  One departure: each layer's gate
constant `gru_rel_pos_const`, stored (1, heads, 1, 1), is a vector of
per-head constants that WavLM starts at 1, so it is drawn as one (1 plus a
uniform on (-0.1, 0.1)), not as a 4-D kernel.

The face is the cell's only part: `draw` returns {"face": state dict}, the
same tensors for the program and for `reference/wavlm.py`."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference import wavlm
from benchmark.weights import _xavier_limit, fp8_rounded, seed63

__all__ = ["draw", "fp8_rounded"]


def _leaves(cfg: dict):
    """[(name, shape, rule)] of the face's state dict, in its order."""
    with torch.device("meta"):
        m = wavlm.build(cfg)["face"]
    emb = {n for n, sub in m.named_modules() if isinstance(sub, nn.Embedding)}
    out = []
    for name, t in m.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        if owner in emb:
            rule = "normal"
        elif leaf == "gru_rel_pos_const":
            rule = "one"
        elif t.dim() >= 2:
            rule = "xavier"
        elif leaf.startswith("bias"):
            rule = "small"
        else:
            rule = "one"
        out.append((name, tuple(t.shape), rule))
    return out


@torch.no_grad()
def draw(cfg: dict, seed: int, device) -> dict:
    """{"face": state dict}, float32 on `device`."""
    leaves = _leaves(cfg)
    n_uni = sum(int(np.prod(s)) for _, s, r in leaves if r != "normal")
    n_nrm = sum(int(np.prod(s)) for _, s, r in leaves if r == "normal")
    gen = torch.Generator(device=device).manual_seed(seed63(seed, 1))
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    sd: dict = {}
    iu = inr = 0
    for name, shape, rule in leaves:
        n = int(np.prod(shape))
        if rule == "normal":
            sd[name] = nrm[inr:inr + n].view(shape)
            inr += n
            continue
        u = uni[iu:iu + n].view(shape)
        iu += n
        sd[name] = (u * _xavier_limit(shape) if rule == "xavier"
                    else u * 0.1 if rule == "small" else 1.0 + 0.1 * u)
    return {"face": sd}

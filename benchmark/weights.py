"""Random weights of a configuration, drawn on the device from the seed.

The benchmark makes the weights and hands the same tensors to the program
and to the reference.  Two draws on one `torch.Generator` of the device
cover every parameter and buffer (a uniform block and a normal block), so
set-up makes no per-leaf host draws.  The rules are those of the models'
own initialisation, with the biases, norm scales and running statistics
moved off their defaults so that a path that drops one of them shows:

- matrices and conv kernels: xavier-uniform;
- embedding tables: standard normal;
- biases: uniform on (-0.1, 0.1); norm scales and other vectors: 1 plus that;
- BatchNorm running means: uniform on (-0.1, 0.1); running variances:
  uniform on (0.8, 1.2);
- codebooks (K, D): xavier-uniform, as TalkSHOW's EMA quantizer starts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference import model as ref_model


def seed63(*parts: int) -> int:
    """A 63-bit seed from any integers (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def _leaves(cfg: dict):
    """[(part, name, shape, rule)] in a fixed order."""
    with torch.device("meta"):
        mods = ref_model.build(cfg)
    out = []
    for part, m in mods.items():
        emb = {n for n, sub in m.named_modules() if isinstance(sub, nn.Embedding)}
        for name, t in m.state_dict().items():
            owner, _, leaf = name.rpartition(".")
            if leaf == "num_batches_tracked":
                rule = "zero_long"
            elif leaf == "running_mean":
                rule = "small"
            elif leaf == "running_var":
                rule = "var"
            elif owner in emb:
                rule = "normal"
            elif t.dim() >= 2:
                rule = "xavier"
            elif leaf.startswith("bias"):
                rule = "small"
            else:
                rule = "one"
            out.append((part, name, tuple(t.shape), rule))
    vq = cfg["vq"]
    for book in ("codebook_body", "codebook_hand"):
        out.append((book, None, (vq["code_num"], vq["embedding_dim"]), "xavier"))
    return out


def _xavier_limit(shape) -> float:
    recept = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * recept, shape[0] * recept
    return (6.0 / (fan_in + fan_out)) ** 0.5


@torch.no_grad()
def draw(cfg: dict, seed: int, device) -> dict:
    """{part: state dict} for the five parts, and {"codebook_body",
    "codebook_hand"}: (K, D) tensors, all float32 on `device`."""
    leaves = _leaves(cfg)
    n_uni = sum(int(np.prod(s)) for _, _, s, r in leaves if r != "normal")
    n_nrm = sum(int(np.prod(s)) for _, _, s, r in leaves if r == "normal")
    gen = torch.Generator(device=device).manual_seed(seed63(seed, 1))
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2).sub_(1)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out: dict = {}
    iu = inr = 0
    for part, name, shape, rule in leaves:
        n = int(np.prod(shape))
        if rule == "normal":
            t = nrm[inr:inr + n].view(shape)
            inr += n
        else:
            u = uni[iu:iu + n].view(shape)
            iu += n
            if rule == "xavier":
                t = u * _xavier_limit(shape)
            elif rule == "small":
                t = u * 0.1
            elif rule == "var":
                t = 1.0 + 0.2 * u
            elif rule == "one":
                t = 1.0 + 0.1 * u
            else:
                t = torch.zeros(shape, dtype=torch.long, device=device)
        if name is None:
            out[part] = t.contiguous()
        else:
            out.setdefault(part, {})[name] = t
    return out


def fp8_rounded(t: torch.Tensor) -> torch.Tensor:
    """`t` through float8 e4m3 with one scale per tensor (its largest
    magnitude at 448) and back to float32: the control's weights."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return ((t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale)

"""Adam that skips a step with non-finite gradients (port of
talkshow_tpu/utils.py:75-114, `skip_nonfinite_updates(optax.adam(...))`).

torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) computes optax.adam's
update.  On a step whose gradients are not all finite, `step()` is not
called, so the moments and Adam's step count stay exactly as they were and
the parameters do not move; `nonfinite_count` goes up by one.  The caller
restores whatever else its forward pass changed (BatchNorm statistics, VQ
state), as the JAX step does with `tree_select`.
"""
from __future__ import annotations

import torch


def all_finite(tensors) -> bool:
    """True when every element of every tensor is finite (one host sync)."""
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


class SkipNonfiniteAdam:
    def __init__(self, params, lr: float):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.nonfinite_count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply Adam if the gradients are finite; returns whether it did."""
        finite = all_finite([p.grad for p in self.params if p.grad is not None])
        if finite:
            self.adam.step()
        else:
            self.nonfinite_count += 1
        return finite

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "nonfinite_count": self.nonfinite_count}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.nonfinite_count = int(sd["nonfinite_count"])

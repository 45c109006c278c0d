"""The optimizer chains of the JAX train steps, with the non-finite skip
(port of talkshow_tpu/utils.py:75-114, `skip_nonfinite_updates`, around
the chains of talkshow_tpu/train/steps.py:49,159-162,250-256).

- stage 1: `skip_nonfinite(adam)` -> `SkipNonfiniteAdam(params, lr)`;
- stage 2: `skip_nonfinite(chain(clip_by_global_norm(5), adam))` ->
  `SkipNonfiniteAdam(params, lr, max_norm=5)`;
- stage 3: `skip_nonfinite(multi_transform({train: chain(clip, sgd(lr,
  momentum)), frozen: set_to_zero}))` -> `SkipNonfiniteSGD(train_params,
  lr, momentum, max_norm)`: the frozen partition is simply not handed to
  the optimizer (its gradients are never computed, so it holds no state).

torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) computes optax.adam's
update.  torch.optim.SGD(lr, momentum, dampening=0, nesterov=False)
computes optax.sgd's: buf = g + m * buf (the first step's buf = g, as
optax's trace starts at zero), param -= lr * buf.

The clip is optax's formula, `g if norm < max_norm else g / norm *
max_norm` with norm the global L2 norm of all gradients; it is not
torch.nn.utils.clip_grad_norm_, which multiplies by max_norm / (norm +
1e-6) clamped to 1, a different number.

optax updates every leaf, whether or not it entered the loss; torch's
optimizers skip a parameter whose `.grad` is None.  So a parameter the
forward did not reach gets a zero gradient before the step (its moments or
momentum decay as optax's do).

On a step whose gradients are not all finite, the inner step is not taken:
the moments, the step counts and the parameters stay exactly as they were;
`nonfinite_count` goes up by one.  The caller restores whatever else its
forward pass changed (BatchNorm statistics, VQ state), as the JAX step does
with `tree_select`.

On a mesh (`mesh`, set by `parallel.collectives.shard_state`) the
gradients are reduced before anything reads them: each rank's loss is its
term of the global mean, so the gradients are summed over the dp ranks
(one all-reduce of all of them, flattened) and equal the one-process
step's on the global batch.  The global norm counts a parameter split over
tp once (its slices' squares summed over tp), the finite check reads the
reduced gradients, and every rank takes the same skip decision (one
all-reduce of the flag).

`SkipNonfinite.step` is traced as the span ``optimizer``; its two host
reads (the finite check's flag and the clip's norm) go through
`tracing.to_host`.
"""
from __future__ import annotations

import torch

from talkshow_torch.tracing import span, to_host


def all_finite(tensors) -> bool:
    """True when every element of every tensor is finite (one host sync)."""
    return bool(to_host(torch.stack([torch.isfinite(t).all() for t in tensors]).all()))


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square (0-dim,
    on the tensors' device)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class SkipNonfinite:
    """skip_nonfinite(chain([clip_by_global_norm(max_norm)], inner)) around
    a torch optimizer of `params`.  `KEY` names the inner optimizer's entry
    in `state_dict`."""
    KEY = "inner"

    mesh = None

    def __init__(self, params, inner: torch.optim.Optimizer, max_norm: float | None = None):
        self.params = list(params)
        self.inner = inner
        self.max_norm = max_norm
        self.nonfinite_count = 0
        self._reduced = False

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)
        self._reduced = False

    def grads(self) -> list:
        """Every parameter's gradient; a parameter the loss did not reach
        gets zeros first, as optax sees it.  On a mesh, summed over the dp
        ranks (once per step)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None and self.mesh.dp > 1 and not self._reduced:
            flat = self.mesh.dp_sum_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        self._reduced = True
        return grads

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the (reduced) gradients; on a mesh with tp
        > 1 a split parameter's slices count once."""
        grads = self.grads()
        if self.mesh is None or self.mesh.tp == 1:
            return global_norm(grads)
        whole = [p.grad for p in self.params if not getattr(p, "tp_sharded", False)]
        split = [p.grad for p in self.params if getattr(p, "tp_sharded", False)]
        sq = sum(torch.sum(g * g) for g in split)
        if torch.is_tensor(sq):
            from torch import distributed as dist
            dist.all_reduce(sq, group=self.mesh.tp_group)
        return torch.sqrt(sum(torch.sum(g * g) for g in whole) + sq)

    def step(self, norm: torch.Tensor | None = None) -> bool:
        """Clip (when max_norm is set; `norm`, the gradients' global norm,
        if the caller has it) and apply the inner step if the gradients are
        finite; returns whether it did."""
        with span("optimizer"):
            grads = self.grads()
            finite = all_finite(grads)
            if self.mesh is not None:
                finite = not self.mesh.any(not finite)
            if finite:
                if self.max_norm is not None:
                    clip_by_global_norm_(grads, self.max_norm,
                                         self.grad_norm() if norm is None else norm)
                self.inner.step()
            else:
                self.nonfinite_count += 1
            return finite

    def state_dict(self) -> dict:
        return {self.KEY: self.inner.state_dict(), "nonfinite_count": self.nonfinite_count}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd[self.KEY])
        self.nonfinite_count = int(sd["nonfinite_count"])


def clip_by_global_norm_(grads: list, max_norm: float, norm: torch.Tensor | None = None) -> None:
    """optax.clip_by_global_norm in place: every g becomes g / norm *
    max_norm unless norm < max_norm (one host read of the norm)."""
    norm = global_norm(grads) if norm is None else norm
    if not float(to_host(norm)) < max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)


class SkipNonfiniteAdam(SkipNonfinite):
    KEY = "adam"

    def __init__(self, params, lr: float, max_norm: float | None = None):
        params = list(params)
        super().__init__(params, torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
                         max_norm)

    @property
    def adam(self) -> torch.optim.Adam:
        return self.inner


class SkipNonfiniteSGD(SkipNonfinite):
    KEY = "sgd"

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 max_norm: float | None = None):
        params = list(params)
        super().__init__(params, torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                                                 nesterov=False), max_norm)

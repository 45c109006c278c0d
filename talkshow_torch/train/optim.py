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

Adam's update as torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)
computes it (`kernels.adam.adam_apply`) is optax.adam's.
torch.optim.SGD(lr, momentum, dampening=0, nesterov=False) computes
optax.sgd's: buf = g + m * buf (the first step's buf = g, as
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
the device counter `nonfinite` goes up by one (`nonfinite_count` reads it
as an int, and sets it).  The caller restores whatever else its forward
pass changed (BatchNorm statistics, VQ state), as the JAX step does with
`tree_select`.

The Adam steps (`SkipNonfiniteAdam`: stages 1 and 2, the body AE, LS3DCG)
make no host read: `kernels.adam.grad_stats` gives the finite flag and
the global norm on the device in one pass, `kernels.adam.adam_apply` clips
and steps in another (two hand-written kernels on the card, their plain
twin on the CPU), and `step` returns the flag as a 0-dim bool tensor, the
caller's `tree_select` condition.  `.adam` stays the `torch.optim.Adam`
whose `state[p]` holds each leaf's `exp_avg` and `exp_avg_sq`; every
leaf's ``"step"`` is the one device count `step_count`.  The SGD step
(stage 3) takes the flag and the norm from the same `grad_stats`, reads
both in one host read, clips on the host's decision and runs
torch.optim.SGD.

On a mesh (`mesh`, set by `parallel.collectives.shard_state`) the
gradients are reduced before anything reads them: each rank's loss is its
term of the global mean, so the gradients are summed over the dp ranks
(one all-reduce of all of them, flattened) and equal the one-process
step's on the global batch.  The global norm counts a parameter split over
tp once (its slices' squares summed over tp), the finite check reads the
reduced gradients, and every rank takes the same skip decision (one
all-reduce of the flag).

`SkipNonfinite.step` is traced as the span ``optimizer``, and defined there
alone (subclasses supply `_apply`); the SGD step's host read goes
through `tracing.to_host`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import distributed as dist

from talkshow_torch.kernels import adam as adam_kernels
from talkshow_torch.tracing import span, to_host

BETAS, EPS = (0.9, 0.999), 1e-8


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
        self.nonfinite = torch.zeros((), dtype=torch.int64,
                                     device=self.params[0].device if self.params else "cpu")
        self._reduced = False
        self._stats = None
        self._work = None
        self._grad_rows = None     # the gradients' leaf table, on the card

    @property
    def nonfinite_count(self) -> int:
        """The steps skipped so far (a read of the device counter)."""
        return int(to_host(self.nonfinite))

    @nonfinite_count.setter
    def nonfinite_count(self, n: int) -> None:
        self.nonfinite.fill_(int(n))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)
        self._reduced = False
        self._stats = None

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

    def _split(self, grads: list) -> tuple[list, list]:
        """(whole, split): the gradients of the parameters a tp mesh keeps
        whole and of those it splits."""
        split = [getattr(p, "tp_sharded", False) for p in self.params]
        return ([g for g, s in zip(grads, split) if not s],
                [g for g, s in zip(grads, split) if s])

    def grad_stats(self) -> tuple:
        """(grads, stats, finite) of this step's (reduced) gradients, taken
        once (`kernels.adam.grad_stats`): stats[1] is the global norm (a
        split parameter's slices counted once on a tp mesh), finite the
        flag every rank agrees on, both on the device."""
        if self._stats is None:
            dev, grads = self.nonfinite.device, self.grads()
            rows = adam_kernels.leaf_rows(dev, grads) if dev.type == "cuda" else None
            if self.mesh is None or self.mesh.tp == 1:
                stats, finite = adam_kernels.grad_stats(grads, self._workspace(), dev, rows)
            else:
                (ws, wf), (ss, sf) = (adam_kernels.grad_stats(g, self._workspace(), dev)
                                      for g in self._split(grads))
                sq = ss[:1].clone()
                dist.all_reduce(sq, group=self.mesh.tp_group)
                total = ws[0] + sq[0]
                stats, finite = torch.stack([total, torch.sqrt(total)]), wf & sf
            if self.mesh is not None and self.mesh.distributed:
                bad = (~finite).float().reshape(1)
                dist.all_reduce(bad)
                finite = bad[0] == 0
            self._stats, self._grad_rows = (grads, stats, finite), rows
        return self._stats

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the (reduced) gradients, on the device."""
        return self.grad_stats()[1][1]

    def _workspace(self):
        if self.nonfinite.device.type != "cuda":
            return None
        if self._work is None:
            self._work = adam_kernels.workspace(len(self.params), self.nonfinite.device)
        return self._work

    def step(self, norm: torch.Tensor | None = None):
        """Clip (when max_norm is set; `norm`, the gradients' global norm,
        if the caller has it) and apply the inner step if the gradients are
        finite; returns whether it did: a bool, or a 0-dim bool tensor on
        the parameters' device (the Adam steps)."""
        with span("optimizer"):
            return self._apply(norm)

    def _apply(self, norm):
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {self.KEY: self.inner.state_dict(), "nonfinite_count": self.nonfinite_count}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd[self.KEY])
        self.nonfinite_count = int(sd["nonfinite_count"])


def clip_by_global_norm_(grads: list, max_norm: float, norm: torch.Tensor | None = None,
                         value: float | None = None) -> None:
    """optax.clip_by_global_norm in place: every g becomes g / norm *
    max_norm unless norm < max_norm; `value` is the norm already read on
    the host (else one host read)."""
    norm = adam_kernels.grad_stats(grads)[0][1] if norm is None else norm
    if not (float(to_host(norm)) if value is None else value) < max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)


class SkipNonfiniteAdam(SkipNonfinite):
    """The Adam chain with no host read (see the module doc): `grad_stats`
    once a step (the flag and the norm, on the device), then
    `kernels.adam.adam_apply` against them."""
    KEY = "adam"

    def __init__(self, params, lr: float, max_norm: float | None = None):
        params = list(params)
        super().__init__(params, torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS),
                         max_norm)
        #: Adam's step count, every leaf's state["step"]: 0-dim f32, as torch keeps it
        self.step_count = torch.zeros((), dtype=torch.float32, device=self.nonfinite.device)
        # on the card: the kernels' leaf table, its parameters' and moments'
        # rows kept while their pointers stay (a load or a reshard moves them)
        self._pointers, self._rows = None, None

    @property
    def adam(self) -> torch.optim.Adam:
        return self.inner


    def _moments(self) -> tuple[list, list]:
        """Every leaf's (exp_avg, exp_avg_sq), made as torch.optim.Adam makes
        them where a leaf has none, with its "step" made `step_count`
        (which takes the count a loaded state brings)."""
        state, count = self.adam.state, self.step_count
        exp_avgs, exp_avg_sqs = [], []
        for p in self.params:
            st = state.get(p)
            if not st:
                st = state[p] = {"step": count}
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = torch.zeros_like(p, memory_format=torch.contiguous_format)
            elif st["step"] is not count:
                loaded = st["step"]
                if loaded.device.type == "cpu":
                    count.fill_(float(loaded))
                else:
                    count.copy_(loaded)
                st["step"] = count
            exp_avgs.append(st["exp_avg"])
            exp_avg_sqs.append(st["exp_avg_sq"])
        return exp_avgs, exp_avg_sqs

    def _adam_rows(self, exp_avgs: list, exp_avg_sqs: list):
        """The kernel's (p, g, m, v, elements) rows: the parameters' and
        moments' checked again only when a pointer moved, the gradients'
        from `grad_stats`."""
        g_rows = self._grad_rows
        if g_rows is None:
            return None
        dev = self.step_count.device
        pointers = [t.data_ptr() for ts in (self.params, exp_avgs, exp_avg_sqs) for t in ts]
        if pointers != self._pointers:
            rows = adam_kernels.leaf_rows(dev, self.params, exp_avgs, exp_avg_sqs)
            self._rows = np.insert(rows, 1, 0, axis=1)
            self._pointers = pointers
        if not np.array_equal(g_rows[:, 1], self._rows[:, 4]):
            raise ValueError("a gradient's size is not its parameter's")
        self._rows[:, 1] = g_rows[:, 0]
        return self._rows

    def _apply(self, norm) -> torch.Tensor:
        # the kernel reads the norm from grad_stats, which `norm` came from
        grads, stats, finite = self.grad_stats()
        exp_avgs, exp_avg_sqs = self._moments()
        group = self.adam.param_groups[0]
        adam_kernels.adam_apply(self.params, grads, exp_avgs, exp_avg_sqs, stats, finite,
                                self.step_count, self.nonfinite, group["lr"], self.max_norm,
                                group["betas"], group["eps"], self._workspace(),
                                self._adam_rows(exp_avgs, exp_avg_sqs))
        self._stats = None
        return finite


class SkipNonfiniteSGD(SkipNonfinite):
    KEY = "sgd"

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 max_norm: float | None = None):
        params = list(params)
        super().__init__(params, torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                                                 nesterov=False), max_norm)

    def _apply(self, norm) -> bool:
        # the flag and the clip's norm from grad_stats, which `norm` came
        # from, in one host read
        grads, stats, finite = self.grad_stats()
        self._stats = None
        ok, value = to_host(torch.stack([finite.to(stats.dtype), stats[1]])).tolist()
        if not ok:
            self.nonfinite.add_(1)
            return False
        if self.max_norm is not None:
            clip_by_global_norm_(grads, self.max_norm, stats[1], value)
        self.inner.step()
        return True

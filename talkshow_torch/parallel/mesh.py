"""The (dp, tp) device mesh (port of talkshow_tpu/parallel/mesh.py:23-75).

Under GSPMD the JAX package's sharded programs compute what the one-device
program computes on the global batch; sharding is an annotation.  The
port has no compiler to insert collectives, so the `Mesh` carries them:
a grid of `torch.device`s with axes ("dp", "tp") and, when it spans the
ranks of a process group (`multihost.global_mesh`), this rank's place in
the grid and its dp and tp sub-groups.  Rank r sits at (r // tp, r % tp),
as JAX's `reshape(dp, tp)` lays devices out.

- Batch rows split over dp (`batch_rows`): dp rank i holds rows
  [i * n / dp, (i + 1) * n / dp).
- `param_spec` is JAX's `_param_spec` (mesh.py:44-59) in the port's
  layout: a flax kernel's last axis (its output channels; a transposed
  convolution's input channels) is dim 0 of the torch weight, and an
  embedding table's rows are dim 0 of both.  So a weight of two or more
  dims whose dim 0 is >= 512 and divisible by tp is split on dim 0;
  everything else (biases, norms, narrow weights) is replicated.
  `collectives.shard_state` applies it.

A mesh without a process group (`make_mesh`) is a plain device grid: the
sample-parallel paths (`Pipeline.generate_body_sharded`, `MotionServer`'s
`mesh`) run one shard per device from one process, with no collectives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

#: JAX's threshold: only tensors at least this wide split over tp
TP_MIN_WIDTH = 512


@dataclass(eq=False)
class Mesh:
    """A (dp, tp) grid of devices.  `rank`, `dp_group` and `tp_group` are
    set when the mesh spans the ranks of a process group (one device per
    rank); then the collective helpers below reduce over them, and with
    dp = tp = 1 they compute locally."""
    devices: np.ndarray            # (dp, tp) of torch.device
    rank: int = 0
    dp_group: Any = None
    tp_group: Any = None
    distributed: bool = False
    axis_names = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    @property
    def tp(self) -> int:
        return self.devices.shape[1]

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` at index 0 of the other axis: where the
        shards of a batch split over `axis` run."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}, not {axis!r}")
        return list(self.devices[:, 0] if axis == "dp" else self.devices[0, :])

    # -- reductions over the global batch (identity at dp = 1) ---------------
    def dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's term of the mean of x over the global batch: x.mean()
        at dp = 1, else x.sum() / (x.numel() * dp).  The terms of the dp
        ranks add up to the global mean (every rank holds as many rows)."""
        if self.dp == 1:
            return x.mean()
        return x.sum() / (x.numel() * self.dp)

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the dp ranks, differentiable: the backward sums the
        gradient over them too (each rank's loss term reaches every rank's
        x through the sum).  Identity at dp = 1."""
        if self.dp == 1:
            return x
        from talkshow_torch.parallel.collectives import sum_over
        return sum_over(x, self.dp_group)

    def dp_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """In place, no gradient: x summed over the dp ranks."""
        if self.dp > 1:
            dist.all_reduce(x, group=self.dp_group)
        return x

    def reduce_metrics(self, metrics: dict) -> dict:
        """{name: this rank's term} -> {name: the global value}: one
        all-reduce of the stacked terms over dp (the same bits on every
        rank)."""
        if self.dp == 1 or not metrics:
            return metrics
        stacked = self.dp_sum_(torch.stack([v.detach().float() for v in metrics.values()]))
        return dict(zip(metrics, stacked.unbind()))

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any rank of the mesh."""
        if not self.distributed:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t)
        return bool(t.item() > 0)


def global_mean(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """x.mean(), or on a mesh this rank's term of the global mean."""
    return x.mean() if mesh is None else mesh.dp_mean(x)


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A (dp, tp) grid over `devices` (default: the visible CUDA devices)
    in this process, with no process group.  Raises ValueError unless
    dp * tp is the number of devices, as JAX's make_mesh does."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != #devices={n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp))


def batch_rows(mesh: Mesh, n: int, dp_rank: int) -> slice:
    """The rows of an n-row global batch that dp rank `dp_rank` holds."""
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not split over dp={mesh.dp}")
    b = n // mesh.dp
    return slice(dp_rank * b, (dp_rank + 1) * b)


def param_spec(name: str, x: torch.Tensor, tp: int) -> tuple:
    """JAX's `_param_spec` on a torch parameter: ("tp", None, ...) when
    the tensor splits over tp on dim 0, else () (replicated)."""
    shape = tuple(getattr(x, "shape", ()))
    if tp == 1 or len(shape) < 2 or name.split(".")[-1] != "weight":
        return ()
    if shape[0] % tp == 0 and shape[0] >= TP_MIN_WIDTH:
        return ("tp",) + (None,) * (len(shape) - 1)
    return ()

"""Collectives of the dp x tp steps and the tensor-parallel layers.

Only `all_reduce` and `broadcast` are used: gloo runs those two on CUDA
tensors, which is how several ranks share one card.  A gather is an
all-reduce of zero-padded shards (exact in f32: each element is one
shard's value plus zeros).

Autograd functions (Megatron's f / g pair and the dp statistics):
- `sum_over(x, group)`: forward all-reduce, backward all-reduce.  For a
  sum whose ranks hold different rows (BatchNorm statistics over dp): each
  rank's loss term reaches every rank's x.
- `copy_to(x, group)`: forward identity, backward all-reduce (f).
- `reduce_from(x, group)`: forward all-reduce, backward identity (g).  For
  a sum of partial results whose consumers are replicated over tp.

Tensor parallelism (`shard_state`): every parameter that `mesh.param_spec`
splits keeps only this tp rank's slice of dim 0, in place (the Parameter
object stays, so the optimizer's references hold), and its module computes
with the slice:
- Conv1d / Conv2d / Linear (dim 0 = output channels), column-parallel:
  y = gather(conv(copy_to(x), W_r)) + b;
- ConvTranspose1d (dim 0 = input channels), row-parallel:
  y = reduce_from(conv_transpose(copy_to(x)[:, rows_r], W_r)) + b;
- Embedding (dim 0 = rows): masked lookup of this rank's rows, reduce_from.
Biases stay whole and replicated, as in JAX.  Modules reach this through
`models.layers.dense` / `conv` / `embed` and their own forward.

`unsharded(state)` gathers the whole parameters and optimizer moments for
the length of a `with` block (checkpoints are written and read whole) and
splits them again after it.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.parallel.mesh import Mesh, param_spec


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def _padded(shard: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """shard in its place along `dim` of a zero tensor size times as wide."""
    n = shard.shape[dim]
    pad = [0, 0] * (shard.dim() - 1 - dim % shard.dim()) + [rank * n, (size - 1 - rank) * n]
    return F.pad(shard, pad)


def gather(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each tp rank's slice along `dim`
    (differentiable: the backward takes this rank's slice)."""
    return reduce_from(_padded(shard, dim, mesh.tp_rank, mesh.tp), mesh.tp_group)


# ---------------------------------------------------------------------------
# tensor-parallel layers
# ---------------------------------------------------------------------------

def _column_forward(m: nn.Module, mesh: Mesh, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Conv1d / Conv2d / Linear with this rank's output channels: gather
    the output channels; the input's gradient sums over tp."""
    x = copy_to(x, mesh.tp_group)
    w = m.weight
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    if isinstance(m, nn.Linear):
        y = gather(F.linear(x, w), -1, mesh)
        return y if m.bias is None else y + m.bias.to(y.dtype)
    y = gather(m._conv_forward(x, w, None), 1, mesh)
    if m.bias is None:
        return y
    return y + m.bias.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 2))


def _row_transpose_forward(m: nn.ConvTranspose1d, mesh: Mesh, x: torch.Tensor,
                           dtype=None) -> torch.Tensor:
    """ConvTranspose1d with this rank's input channels: partial outputs
    summed over tp."""
    w = m.weight
    n = w.shape[0]
    x = copy_to(x, mesh.tp_group).narrow(1, mesh.tp_rank * n, n)
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = reduce_from(F.conv_transpose1d(x, w, None, m.stride, m.padding, m.output_padding,
                                       m.groups, m.dilation), mesh.tp_group)
    return y if m.bias is None else y + m.bias.to(y.dtype)[:, None]


def _row_lookup(m: nn.Embedding, mesh: Mesh, idx: torch.Tensor) -> torch.Tensor:
    """Embedding rows of this rank looked up (others zero), summed over tp."""
    n = m.weight.shape[0]
    local = idx - mesh.tp_rank * n
    hit = (local >= 0) & (local < n)
    out = m.weight[local.clamp(0, n - 1)] * hit[..., None].to(m.weight.dtype)
    return reduce_from(out, mesh.tp_group)


def _shard_module(m: nn.Module, mesh: Mesh) -> None:
    """Route the module's compute through its tp slice (see module doc)."""
    if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        if getattr(m, "groups", 1) != 1:
            raise NotImplementedError(f"tensor parallelism of a grouped {type(m).__name__}")
        m.tp_forward = functools.partial(_column_forward, m, mesh)
    elif isinstance(m, nn.ConvTranspose1d):
        m.tp_forward = functools.partial(_row_transpose_forward, m, mesh)
    elif isinstance(m, nn.Embedding):
        m.tp_lookup = functools.partial(_row_lookup, m, mesh)
        m.forward = m.tp_lookup
        return
    else:
        raise NotImplementedError(f"tensor parallelism of {type(m).__name__}")
    m.forward = m.tp_forward


def _split(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[0] // mesh.tp
    return t.narrow(0, mesh.tp_rank * n, n).clone()


def whole(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each tp rank's slice of dim 0 (no gradient)."""
    out = _padded(t, 0, mesh.tp_rank, mesh.tp)
    dist.all_reduce(out, group=mesh.tp_group)
    return out


def state_parts(state) -> tuple[list, list]:
    """(modules, optimizers) of a train state: the nn.Modules and the
    `train.optim.SkipNonfinite` optimizers among its fields (alone or in a
    dict)."""
    from talkshow_torch.train.optim import SkipNonfinite
    modules, optimizers = [], []
    for v in vars(state).values():
        for item in (v.values() if isinstance(v, dict) else (v,)):
            if isinstance(item, nn.Module):
                modules.append(item)
            elif isinstance(item, SkipNonfinite):
                optimizers.append(item)
    return modules, optimizers


def _moments(optimizers: list, p: torch.Tensor) -> list:
    """(state dict, key) of every tensor of p's optimizer state shaped like p."""
    out = []
    for opt in optimizers:
        st = opt.inner.state.get(p, {})
        out += [(st, k) for k, v in st.items() if torch.is_tensor(v) and v.shape == p.shape]
    return out


def shard_state(mesh: Mesh, state):
    """Put a train state on the mesh, in place: every train-mode
    BatchNorm takes its statistics over the global batch, every VQ-VAE its
    EMA sums, and the steps and optimizers reduce over the mesh
    (`state.mesh`, `optimizer.mesh`); with tp > 1 every parameter that
    `param_spec` splits keeps this rank's slice (optimizer moments too)."""
    from talkshow_torch.models.layers import FlaxBatchNorm1d
    from talkshow_torch.models.vqvae import VQVAE
    modules, optimizers = state_parts(state)
    state.mesh = mesh
    for opt in optimizers:
        opt.mesh = mesh
    for model in modules:
        for m in model.modules():
            if isinstance(m, (FlaxBatchNorm1d, VQVAE)):
                m.mesh = mesh
        if mesh.tp == 1:
            continue
        for name, m in list(model.named_modules()):
            for pname, p in list(m.named_parameters(recurse=False)):
                if not param_spec(pname, p, mesh.tp):
                    continue
                _shard_module(m, mesh)
                with torch.no_grad():
                    p.data = _split(p.data, mesh)
                p.tp_sharded = True
    _reshard_moments(state)
    return state


def _sharded_params(state) -> list:
    modules, _ = state_parts(state)
    return [p for m in modules for p in m.parameters() if getattr(p, "tp_sharded", False)]


def _reshard_moments(state) -> None:
    """Slice every whole optimizer moment of a sharded parameter."""
    mesh = getattr(state, "mesh", None)
    if mesh is None or mesh.tp == 1:
        return
    _, optimizers = state_parts(state)
    for p in _sharded_params(state):
        for opt in optimizers:
            st = opt.inner.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() and v.shape[0] == p.shape[0] * mesh.tp:
                    st[k] = _split(v, mesh)


@contextlib.contextmanager
def unsharded(state):
    """Inside the block every split parameter and optimizer moment of the
    state is whole (all tp ranks must enter together); after it, each is
    this rank's slice again (of what the block left, e.g. a loaded
    checkpoint).  A no-op without tp."""
    mesh = getattr(state, "mesh", None)
    if mesh is None or mesh.tp == 1:
        yield state
        return
    _, optimizers = state_parts(state)
    params = _sharded_params(state)
    with torch.no_grad():
        for p in params:
            for st, k in _moments(optimizers, p):
                st[k] = whole(st[k], mesh)
            p.data = whole(p.data, mesh)
    try:
        yield state
    finally:
        with torch.no_grad():
            for p in params:
                p.data = _split(p.data, mesh)
        _reshard_moments(state)

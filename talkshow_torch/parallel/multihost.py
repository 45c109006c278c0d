"""Several processes, one device each (port of
talkshow_tpu/parallel/multihost.py:22-85).

JAX runs one process per host with several devices each; PyTorch runs one
process (rank) per device.  `initialize_multihost` starts the process
group, `global_mesh` lays every rank out on a (dp, tp) grid with its dp
and tp sub-groups, and `make_global_batch` hands each rank its rows of a
global batch that every rank builds alike from the shared seed.

The backend is the caller's to name: "nccl" when every rank has a card of
its own, "gloo" for CPU ranks and for several ranks sharing one card (gloo
all-reduces and broadcasts CUDA tensors too; the port's steps use only
those two collectives).  Nothing falls back from one to the other.

Under `torchrun` every argument can come from its environment (WORLD_SIZE,
RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT).  JAX's
Gloo warm-up (`warmup_collectives`) is not ported: it works around a
compile-time skew that eager PyTorch does not have.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from talkshow_torch.parallel.mesh import Mesh, batch_rows

BACKENDS = ("nccl", "gloo")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """Ranks on this host (torchrun's LOCAL_WORLD_SIZE; else every rank)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def local_rank() -> int:
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout_s: float = 300.0) -> bool:
    """torch.distributed.init_process_group over `num_processes` ranks;
    returns whether it started a group (a no-op for one process).

    coordinator_address "host:port" (else torchrun's MASTER_ADDR /
    MASTER_PORT), num_processes (else WORLD_SIZE), process_id (else RANK).
    backend "nccl" or "gloo", named by the caller.  NCCL needs a card per
    rank: it raises ValueError when this host has fewer cards than ranks."""
    n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if n == 1:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"name the process group's backend: 'nccl' (a card per rank) or "
                         f"'gloo' (CPU ranks, or ranks sharing a card), not {backend!r}")
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend == "nccl":
        here = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < here:
            raise ValueError(f"nccl needs a card per rank: {here} ranks on this host, {cards} "
                             f"card(s); use backend 'gloo' for ranks that share a card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK (modulo the cards
    present, so that ranks of a gloo group can share one)."""
    if torch.device(kind).type != "cuda":
        return torch.device(kind)
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def global_mesh(dp: int | None = None, tp: int = 1, device=None) -> Mesh:
    """The (dp, tp) mesh over every rank of the process group, this rank
    on `device` (default `rank_device()`).  Raises ValueError unless dp * tp
    is the number of ranks, and when tp exceeds the ranks of one host, so
    that tensor collectives never leave a host (multihost.py:60-70)."""
    n = world_size()
    dp = dp if dp is not None else n // tp
    if dp * tp != n:
        hint = ("" if dist.is_initialized() else
                f": no process group is up; launch one process per device, e.g. "
                f"`torchrun --nproc_per_node {dp * tp} -m talkshow_torch.train ...`")
        raise ValueError(f"dp*tp={dp * tp} != global ranks {n}{hint}")
    per_host = local_world_size()
    if tp > per_host:
        raise ValueError(f"tp={tp} would cross hosts (per-host={per_host})")
    device = torch.device(device) if device is not None else rank_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.empty(n, dtype=object)
    grid[:] = _all_devices(device, rank, n)
    mesh = Mesh(grid.reshape(dp, tp), rank=rank, distributed=n > 1)
    if n > 1:
        # every rank creates every group, in one order
        for j in range(tp):
            g = dist.new_group([i * tp + j for i in range(dp)])
            if mesh.tp_rank == j:
                mesh.dp_group = g
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if mesh.dp_rank == i:
                mesh.tp_group = g
    return mesh


def _all_devices(device: torch.device, rank: int, n: int) -> list:
    """Every rank's device, from one all-reduce of (kind, index) pairs."""
    if n == 1:
        return [device]
    t = torch.zeros((n, 2), dtype=torch.int64, device=device)
    t[rank, 0] = 1 if device.type == "cuda" else 0
    t[rank, 1] = device.index or 0
    dist.all_reduce(t)
    return [torch.device("cuda", int(i)) if int(k) else torch.device("cpu")
            for k, i in t.cpu().tolist()]


def make_global_batch(mesh: Mesh, global_batch: dict) -> dict:
    """A global batch (numpy arrays of n rows, alike on every rank) -> this
    rank's rows as tensors on its device (tests/multihost_worker.py:62-66:
    process i feeds rows [i * n / p, (i + 1) * n / p))."""
    out = {}
    for k, v in global_batch.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(v[batch_rows(mesh, v.shape[0], mesh.dp_rank)]).to(mesh.device)
    return out

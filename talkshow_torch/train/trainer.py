"""Training runtime: epoch loop, logging, checkpoint/resume (port of
talkshow_tpu/train/trainer.py:67-275).

The Trainer drives one stage's step over a `ShowDataset`, logs a running
loss dict every `print_every` steps, writes `history.json`, and checkpoints
the whole train state (module state dicts under the reference's names, VQ
states, optimizer, step, epoch) with `torch.save` every `save_every`
epochs, so a resumed run continues with the optimizer's moments.

Batches are the dataset's training windows (`batch_mode="windows"`) or,
for the face stage, whole clips (`"face_clips"`: batch 1, or length
buckets of `face_bucket_frames` grouped by `face_batch_size`).  A step that
`needs_rng` gets a torch.Generator on the trainer's device seeded from
(train.seed, global step), so that a resumed run draws what the
uninterrupted one would.  With a `token_encoder` (the frozen stage-1
encode), token grids are cached per training window (`window_key`: clip,
start): a batch whose windows are all cached brings its `tokens` and no
poses; a miss is encoded on the device, the step reads the device tokens,
and their host copies are taken at the next print or the epoch's end, off
the step's path (JAX's `drain_cache`).  Unlike JAX's, the first epoch
ends by encoding every window the dataset can give that is not cached yet
(`fill_cache`, batches of the step's size): a batch hits only when all of
its windows are cached, and with 128 windows that each keep their epoch-1
jitter offset with probability 1/2, JAX's cache misses every batch of
every later epoch.  The cache is not checkpointed; a resumed run refills
it.  It belongs to one trainer and its dataset, so the 6-D variant's
windows (330-wide poses, encoded by 78 / 180-channel VQs) never meet 3-D
ones in it; `ShowDataset.from_root`'s pickle cache is keyed by
convert_to_6d as well.

Each epoch draws its window jitter and order from
np.random.default_rng(seed + epoch) (the JAX trainer draws from one
generator per `train()` call; the first epoch is the same), so a run
resumed at an epoch boundary sees the batches an uninterrupted run sees.
On the card such a run equals an uninterrupted one bit for bit when cuDNN
runs deterministic algorithms, as `python -m talkshow_torch.train` sets
it to.

`config.parallel` (dp, tp) is honoured as JAX's `setup` and `_put_batch`
do: with dp * tp > 1 the trainer runs as one rank of a process group of
dp * tp ranks (`torchrun --nproc_per_node dp*tp -m talkshow_torch.train`;
without such a group `setup` raises, where it would otherwise train on one
device).  Its `mesh` (`parallel.multihost.global_mesh`) puts the state on
the mesh (`parallel.collectives.shard_state`: global-batch BatchNorm, EMA
and losses, gradients summed over dp, wide weights split over tp).  Every
rank builds the same global batch from the shared seed and puts only its
rows on its device; the step generator is seeded alike on every rank.
The token cache holds the grids this rank encoded (its rows of each
missed batch, and at the end of epoch 1 every window, in batches of its
share of the step); whether a batch hits is agreed over the ranks by one
all-reduce of the miss flag, so every rank runs the same step.  Rank 0
alone writes config.json, the log, history.json and the checkpoints,
which hold whole parameters (`collectives.unsharded`); `resume` loads on
every rank.  The metrics are the global ones.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from talkshow_torch.config import Config
from talkshow_torch.data.dataset import ShowDataset, compute_norm_stats, normalize_poses
from talkshow_torch.parallel.collectives import shard_state, unsharded
from talkshow_torch.parallel.mesh import batch_rows
from talkshow_torch.parallel.multihost import global_mesh, world_size

log = logging.getLogger("talkshow_torch")


def prefetch_iter(iterable, depth: int = 2):
    """Yield the items of `iterable` while a background thread produces the
    next `depth` (host-side window slicing and stacking overlap the step).
    Order-preserving; an exception in the producer re-raises here."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def producer():
        try:
            for item in iterable:
                q.put((None, item))
        except BaseException as e:  # noqa: BLE001 -- forwarded to the consumer
            q.put((e, None))
            return
        q.put((None, end))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        err, item = q.get()
        if err is not None:
            raise err
        if item is end:
            return
        yield item


def step_seed(seed: int, step: int) -> int:
    """The seed of global step `step`'s generator in a run seeded `seed`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


@dataclass
class Trainer:
    """Drives `step_fn(state, batch[, generator]) -> (state, metrics)` over
    the dataset's batches (`batch_mode` "windows" or "face_clips").
    `init_state_fn(generator, device)` makes the state, which has
    `state_dict` / `load_state_dict`.  `batch_keys`: the batch entries the
    step reads (None: all); the rest never go to the device.
    `token_encoder`: poses (device) -> token grids, cached per window.
    `mesh`: a `parallel.mesh.Mesh` over the process group's ranks; made
    from `config.parallel` by `setup` when dp * tp > 1."""
    config: Config
    dataset: ShowDataset
    init_state_fn: Callable
    step_fn: Callable
    run_dir: str = "experiments/run"
    device: Any = "cuda"
    state: Any = None
    epoch: int = 0
    global_step: int = 0
    history: list = field(default_factory=list)
    batch_keys: tuple | None = None
    needs_rng: bool = False
    batch_mode: str = "windows"
    face_bucket_frames: int = 0
    face_batch_size: int = 1
    token_encoder: Callable | None = None
    mesh: Any = None
    _token_cache: dict = field(default_factory=dict)

    @property
    def lead(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def setup(self) -> "Trainer":
        self.device = torch.device(self.device)
        pc = self.config.parallel
        if self.mesh is None and (pc.dp * pc.tp > 1 or world_size() > 1):
            self.mesh = global_mesh(pc.dp, pc.tp, device=self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
            if self.batch_mode == "face_clips":
                raise NotImplementedError("make_face_step (s2g_face) does not run on a dp x tp "
                                          "mesh yet: train the face stage on one device")
        os.makedirs(self.run_dir, exist_ok=True)
        if self.lead:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                f.write(self.config.to_json())
        if self.lead and not any(getattr(h, "_talkshow_run", None) == self.run_dir
                                 for h in log.handlers):
            fh = logging.FileHandler(os.path.join(self.run_dir, "train.log"))
            fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            fh._talkshow_run = self.run_dir
            log.addHandler(fh)
            log.setLevel(logging.INFO)
        if self.state is None:
            gen = torch.Generator().manual_seed(self.config.train.seed)
            self.state = self.init_state_fn(gen, self.device)
        if self.mesh is not None:
            shard_state(self.mesh, self.state)
        return self

    def put_batch(self, batch: dict) -> dict:
        """Normalise poses (when the config asks) and move to the device."""
        if self.config.data.pose.normalization and "poses" in batch:
            if not hasattr(self, "_norm_stats"):
                self._norm_stats = compute_norm_stats(self.dataset)
                if self.lead:
                    np.save(os.path.join(self.run_dir, "norm_stats.npy"),
                            np.stack(self._norm_stats))
            batch = dict(batch, poses=normalize_poses(batch["poses"], self._norm_stats))
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def batch_iter(self, epoch: int):
        """The epoch's batches (numpy dicts)."""
        if self.batch_mode == "face_clips":
            return self.dataset.face_batches(bucket_frames=self.face_bucket_frames,
                                             batch_size=self.face_batch_size)
        if self.batch_mode != "windows":
            raise ValueError(f"batch_mode is 'windows' or 'face_clips', not {self.batch_mode!r}")
        np_rng = np.random.default_rng(self.config.train.seed + epoch)
        return self.dataset.batches(self.config.train.batch_size, np_rng)

    def device_batch(self, batch: dict, pending_cache: list) -> dict:
        """A numpy batch -> the step's device batch: the entries it reads,
        and with a token encoder its `tokens` in place of the poses, from
        the cache or encoded here (the keys and device tokens are appended
        to pending_cache for `drain_cache`).  On a mesh, this rank's rows."""
        wkey = batch.get("window_key")
        batch = {k: v for k, v in batch.items()
                 if k != "window_key" and isinstance(v, np.ndarray)
                 and (self.batch_keys is None or k in self.batch_keys)}
        if self.mesh is not None:
            rows = batch_rows(self.mesh, len(next(iter(batch.values()))), self.mesh.dp_rank)
            batch = {k: v[rows] for k, v in batch.items()}
            wkey = None if wkey is None else wkey[rows]
        if self.token_encoder is None or wkey is None:
            return self.put_batch(batch)
        keys = [tuple(map(int, k)) for k in wkey]
        hit = all(k in self._token_cache for k in keys)
        if self.mesh is not None:
            hit = not self.mesh.any(not hit)
        if hit:
            batch.pop("poses", None)
            out = self.put_batch(batch)
            out["tokens"] = torch.as_tensor(np.stack([self._token_cache[k] for k in keys]),
                                            device=self.device)
            return out
        out = self.put_batch(batch)
        out["tokens"] = self.token_encoder(out.pop("poses"))
        pending_cache.append((keys, out["tokens"]))
        return out

    def drain_cache(self, pending_cache: list) -> None:
        """Host copies of the tokens encoded since the last drain into the
        cache (one read each, at print time or the epoch's end)."""
        for keys, tokens in pending_cache:
            for k, t in zip(keys, tokens.cpu().numpy()):
                self._token_cache[k] = t
        pending_cache.clear()

    def fill_cache(self) -> int:
        """Encode every window of the dataset that is not cached, in batches
        of train.batch_size windows (on a mesh, this rank's share of them;
        the last one padded by repeating its last window, so that every
        encode has the step's shape); returns the number of encode calls."""
        keys = [k for k in self.dataset.window_keys() if k not in self._token_cache]
        B = self.config.train.batch_size // (1 if self.mesh is None else self.mesh.dp)
        for i in range(0, len(keys), B):
            chunk = keys[i:i + B]
            chunk += chunk[-1:] * (B - len(chunk))
            poses = np.stack([self.dataset.window_poses(k) for k in chunk])
            tokens = self.token_encoder(self.put_batch({"poses": poses})["poses"])
            self.drain_cache([(chunk, tokens)])
        return -(-len(keys) // B)

    def step_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.config.train.seed, self.global_step))

    def train(self, epochs: int | None = None):
        epochs = epochs if epochs is not None else self.config.train.epochs
        print_every = self.config.log.print_every
        save_every = self.config.log.save_every
        for epoch in range(self.epoch, epochs):
            running: dict[str, float] = {}
            pending: dict[str, list] = {}
            pending_cache: list = []
            count = 0
            t0 = time.time()
            for batch in prefetch_iter(self.batch_iter(epoch), depth=2):
                batch = self.device_batch(batch, pending_cache)
                if self.needs_rng:
                    self.state, metrics = self.step_fn(self.state, batch, self.step_generator())
                else:
                    self.state, metrics = self.step_fn(self.state, batch)
                self.global_step += 1
                count += 1
                for k, v in metrics.items():
                    pending.setdefault(k, []).append(v)
                if self.global_step % print_every == 0:
                    self._collapse(running, pending)
                    avg = {k: v / count for k, v in running.items()}
                    if self.lead:
                        log.info(f"epoch {epoch} step {self.global_step} "
                                 + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
                    self.drain_cache(pending_cache)
            self.epoch = epoch + 1
            self.drain_cache(pending_cache)
            if self.token_encoder is not None:
                self.fill_cache()
            self._collapse(running, pending)
            avg = {k: v / count if count else 0.0 for k, v in running.items()}
            avg["epoch_seconds"] = time.time() - t0
            if self.device.type == "cuda":
                avg["hbm_in_use_gb"] = round(torch.cuda.memory_allocated(self.device) / 2**30, 3)
            self.history.append({"epoch": epoch, **avg})
            if (epoch + 1) % save_every == 0 or epoch + 1 == epochs:
                self.save(os.path.join(self.run_dir, f"ckpt-{epoch}.pt"))
        if self.lead:
            with open(os.path.join(self.run_dir, "history.json"), "w") as f:
                json.dump(self.history, f, indent=1)
        return self.state

    @staticmethod
    def _collapse(running: dict, pending: dict) -> None:
        """Fold the metrics gathered since the last print into the sums
        (one host read per value, at print time, not per step)."""
        for k, vs in pending.items():
            running[k] = running.get(k, 0.0) + sum(float(v) for v in vs)
        pending.clear()

    def save(self, path: str) -> None:
        """Rank 0 writes the whole state (every tp rank takes part in the
        gather)."""
        with unsharded(self.state):
            if self.lead:
                torch.save({"state": self.state.state_dict(), "epoch": self.epoch,
                            "global_step": self.global_step}, path)

    def resume(self, path: str) -> "Trainer":
        # load on the host: load_state_dict puts each tensor where its
        # parameter lives, and keeps Adam's step counts on the host
        ckpt = torch.load(path, map_location="cpu")
        with unsharded(self.state):
            self.state.load_state_dict(ckpt["state"])
        self.epoch = int(ckpt["epoch"])
        self.global_step = int(ckpt["global_step"])
        return self

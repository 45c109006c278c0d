"""Training runtime: epoch loop, logging, checkpoint/resume (port of
talkshow_tpu/train/trainer.py:67-275, window batches).

The Trainer drives one stage's step over a `ShowDataset`, logs a running
loss dict every `print_every` steps, writes `history.json`, and checkpoints
the whole train state (module state dicts under the reference's names, VQ
states, optimizer, step, epoch) with `torch.save` every `save_every`
epochs, so a resumed run continues with the optimizer's moments.

Each epoch draws its window jitter and order from
np.random.default_rng(seed + epoch) (the JAX trainer draws from one
generator per `train()` call; the first epoch is the same), so a run
resumed at an epoch boundary sees the batches an uninterrupted run sees.
On the card such a run equals an uninterrupted one bit for bit when cuDNN
runs deterministic algorithms, as `python -m talkshow_torch.train` sets
it to.  The frozen-token cache and the face stage's
whole-clip batches wait for their slices (ROADMAP.md).
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


@dataclass
class Trainer:
    """Drives `step_fn(state, batch) -> (state, metrics)` over the dataset's
    window batches.  `init_state_fn(generator, device)` makes the state,
    which has `state_dict` / `load_state_dict`.  `batch_keys`: the batch
    entries the step reads (None: all); the rest never go to the device."""
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

    def setup(self) -> "Trainer":
        self.device = torch.device(self.device)
        os.makedirs(self.run_dir, exist_ok=True)
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            f.write(self.config.to_json())
        if not any(getattr(h, "_talkshow_run", None) == self.run_dir for h in log.handlers):
            fh = logging.FileHandler(os.path.join(self.run_dir, "train.log"))
            fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            fh._talkshow_run = self.run_dir
            log.addHandler(fh)
            log.setLevel(logging.INFO)
        if self.state is None:
            gen = torch.Generator().manual_seed(self.config.train.seed)
            self.state = self.init_state_fn(gen, self.device)
        return self

    def put_batch(self, batch: dict) -> dict:
        """Normalise poses (when the config asks) and move to the device."""
        if self.config.data.pose.normalization and "poses" in batch:
            if not hasattr(self, "_norm_stats"):
                self._norm_stats = compute_norm_stats(self.dataset)
                np.save(os.path.join(self.run_dir, "norm_stats.npy"),
                        np.stack(self._norm_stats))
            batch = dict(batch, poses=normalize_poses(batch["poses"], self._norm_stats))
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def train(self, epochs: int | None = None):
        epochs = epochs if epochs is not None else self.config.train.epochs
        print_every = self.config.log.print_every
        save_every = self.config.log.save_every
        for epoch in range(self.epoch, epochs):
            np_rng = np.random.default_rng(self.config.train.seed + epoch)
            running: dict[str, float] = {}
            pending: dict[str, list] = {}
            count = 0
            t0 = time.time()
            batch_iter = self.dataset.batches(self.config.train.batch_size, np_rng)
            for batch in prefetch_iter(batch_iter, depth=2):
                batch = {k: v for k, v in batch.items()
                         if k != "window_key" and isinstance(v, np.ndarray)
                         and (self.batch_keys is None or k in self.batch_keys)}
                self.state, metrics = self.step_fn(self.state, self.put_batch(batch))
                self.global_step += 1
                count += 1
                for k, v in metrics.items():
                    pending.setdefault(k, []).append(v)
                if self.global_step % print_every == 0:
                    self._collapse(running, pending)
                    avg = {k: v / count for k, v in running.items()}
                    log.info(f"epoch {epoch} step {self.global_step} "
                             + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
            self.epoch = epoch + 1
            self._collapse(running, pending)
            avg = {k: v / count if count else 0.0 for k, v in running.items()}
            avg["epoch_seconds"] = time.time() - t0
            if self.device.type == "cuda":
                avg["hbm_in_use_gb"] = round(torch.cuda.memory_allocated(self.device) / 2**30, 3)
            self.history.append({"epoch": epoch, **avg})
            if (epoch + 1) % save_every == 0 or epoch + 1 == epochs:
                self.save(os.path.join(self.run_dir, f"ckpt-{epoch}.pt"))
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
        torch.save({"state": self.state.state_dict(), "epoch": self.epoch,
                    "global_step": self.global_step}, path)

    def resume(self, path: str) -> "Trainer":
        # load on the host: load_state_dict puts each tensor where its
        # parameter lives, and keeps Adam's step counts on the host
        ckpt = torch.load(path, map_location="cpu")
        self.state.load_state_dict(ckpt["state"])
        self.epoch = int(ckpt["epoch"])
        self.global_step = int(ckpt["global_step"])
        return self

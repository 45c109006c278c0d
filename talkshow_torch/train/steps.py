"""Train steps of the port (talkshow_tpu/train/steps.py).

Stage 1 (`make_body_vq_step`, steps.py:35-107): the compositional body and
hand VQ-VAEs, losses as the reference (smplx_body_vq.py:177-206): per part
L1 reconstruction + L1 velocity + commitment, summed; Adam with the
non-finite skip.  `make_token_encoder` (steps.py:121-142) is the frozen-VQ
encode that feeds prior training.  On the card each VQ-VAE forward runs K4
once (`ops/vq.nearest_code`).

Stage 2 (`make_body_pixel_step`, steps.py:145-235): the PixelCNN prior and
the audio encoder (batch-statistics BatchNorm) on the token grids of the
frozen stage-1 VQs (K4 twice on the card, unless the batch brings cached
`tokens`); f32 cross-entropy over the codebook logits; clip-by-global-norm
then Adam, with the non-finite skip.

Stage 3 (`make_face_step`, steps.py:244-320): the face generator with its
wav2vec conv extractor frozen: the extractor runs under no_grad (K3 with
f32 tables on the card for whole clips, bf16 tables when the model
computes in bf16; the plain masked extractor for bucketed batches), the rest trains with clip-by-global-norm then SGD with
momentum; L1 on the first 6 channels + MSE on the last 100, over real
frames only for bucketed batches.

The body AE (`make_body_ae_step`, steps.py:406-444), the FGD feature net:
the plain autoencoder over the 129 conv channels, L1 reconstruction + L1
velocity, Adam with the non-finite skip; no quantizer, so no kernel.

The LS3DCG baseline (`make_ls3dcg_step`, steps.py:312-404): the LSGAN
step, the discriminator updated first against a detached generator
forward in eval mode, then the generator against the refreshed
discriminator in eval mode; each model has its own Adam with the
non-finite skip; no kernel.

Mixed precision (`--bf16`, JAX scripts/train.py:47-50,150,166): the prior
built with `dtype=torch.bfloat16` and the face generator with
`Wav2Vec2Config(dtype=torch.bfloat16)` compute in bf16 at flax's sites;
parameters, optimizer state and checkpoints stay f32, and the losses are
taken in f32.

`rep6d=True` on stage 1, the token encoder and stage 2 is the 6-D pose
variant (convert_to_6d): poses (T, 330), the conv channels picked by
C_INDEX_6D, 78 body / 180 hand channels; the reference then trains a prior
of dim 512 x 10 layers, whose decode K1 runs at that shape.

The stochastic steps take a `torch.Generator` for their dropout and
SpecAugment draws; a batch may instead carry the masks (`aud_keep`;
`spec_starts`, `drop_keep`), which is how the tests hand in JAX's own.

Stages 1 and 2 are traced (`talkshow_torch.tracing`): a step is the root
span ``train_step`` (batch, frames) over ``forward``, ``backward`` and
``optimizer`` (in stage 2 also around the clip's norm, which the step
reports); stage 1's conv-channel index is copied to the card by
`tracing.to_device`, one host sync a step.

Unlike the JAX package, where the state is an immutable pytree, the state
here holds the modules (parameters and BatchNorm statistics) and the
optimizer, and a step updates them in place.  The Adam steps (stages 1
and 2, the body AE, LS3DCG) read nothing back from the card: the
optimizer's skip decision stays a device flag, and a skipped step's
BatchNorm statistics and VQ states are put back by a select on it.

On a dp x tp mesh (`state.mesh`, set by `parallel.collectives.shard_state`;
JAX's sharded steps compute what its one-device step computes on the
global batch) every step takes this rank's rows and computes the
one-process step on the global batch: each loss is this rank's term of
the global mean (`Mesh.dp_mean`; the velocity and commitment terms count
B x T elements; the face step's masked losses divide by the real frames
summed over dp), BatchNorm and the EMA quantizer reduce their statistics
over dp, the optimizer sums the gradients over dp, the metrics are the
global values (one all-reduce), and the random masks (the body-pixel
step's audio dropout, the face step's SpecAugment starts and dropout) are
drawn for the global batch and sliced to this rank's rows, so every rank,
seeded alike, draws the one-process step's bits.  The face step's frozen
extractor stays whole on every rank (`shard_state` splits no frozen
weight), so K3 runs on whole tables there; a bucketed batch runs the plain
masked extractor, as on one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from talkshow_torch.kernels.wav2vec_extractor import pack_extractor_tables
from talkshow_torch.models.face import FaceGenerator, draw_drop_keep
from talkshow_torch.models.layers import FlaxBatchNorm1d, init_weights_
from talkshow_torch.models.ls3dcg import LS3DCGDiscriminator, LS3DCGGenerator
from talkshow_torch.models.pixelcnn import GatedPixelCNN, draw_aud_keep
from talkshow_torch.models.vqvae import AE, VQVAE, AudioEncoder
from talkshow_torch.models.wav2vec import draw_spec_starts
from talkshow_torch.models.wav2vec_fused import frozen_features
from talkshow_torch.ops import vq as vq_ops
from talkshow_torch.ops.pose import BODY_DIM, C_INDEX_3D, C_INDEX_6D, FULL_POSE_DIM, HAND_DIM
from talkshow_torch.parallel.mesh import global_mean
from talkshow_torch.tracing import span, to_device
from talkshow_torch.train.optim import SkipNonfiniteAdam, SkipNonfiniteSGD

def parts(rep6d: bool = False) -> tuple:
    """The (name, channel slice) of each VQ-VAE's conv channels: body 39 and
    hand 90, or 78 and 180 in the 6-D variant."""
    body, hand = (2 * BODY_DIM, 2 * HAND_DIM) if rep6d else (BODY_DIM, HAND_DIM)
    return (("body", slice(0, body)), ("hand", slice(body, body + hand)))


PARTS = parts()


def conv_channels(poses: torch.Tensor, rep6d: bool = False) -> torch.Tensor:
    """(B, T, 165) poses -> the 129 conv channels, or with rep6d (B, T, 330)
    -> the 258 (C_INDEX_6D); poses of another width pass, as in JAX."""
    full, index = (2 * FULL_POSE_DIM, C_INDEX_6D) if rep6d else (FULL_POSE_DIM, C_INDEX_3D)
    if poses.shape[-1] != full:
        return poses
    return poses[..., to_device(index, poses.device)]


@dataclass
class BodyVQState:
    """Stage-1 train state: the VQ-VAEs {'body', 'hand'} (their parameters
    and BatchNorm statistics), their VQStates, the optimizer and the step."""
    models: dict
    vq: dict
    optimizer: SkipNonfiniteAdam
    step: int = 0
    mesh: Any = None

    def state_dict(self) -> dict:
        """Module state dicts under the reference's names, VQ states, the
        optimizer and the step: everything `torch.save` needs to resume."""
        return {"models": {k: m.state_dict() for k, m in self.models.items()},
                "vq": {k: s._asdict() for k, s in self.vq.items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for k, m in self.models.items():
            m.load_state_dict(sd["models"][k])
        dev = next(self.models["body"].parameters()).device
        self.vq = {k: vq_ops.VQState(**s).to(dev) for k, s in sd["vq"].items()}
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])

    @torch.no_grad()
    def load_converted(self, weights: dict) -> "BodyVQState":
        """Load `convert.from_jax_body_vq_state`'s output in place: the same
        parameters, statistics, codebooks, Adam moments and counts as the
        JAX state."""
        dev = next(self.models["body"].parameters()).device
        for part, model in self.models.items():
            model.load_state_dict(weights[f"vq_{part}"])
            self.vq[part] = weights[f"vq_{part}_state"].to(dev)
        _load_adam(self.optimizer, {f"vq_{k}": m for k, m in self.models.items()}, weights)
        self.step = weights["step"]
        return self


def _load_adam(optimizer: SkipNonfiniteAdam, models: dict, weights: dict) -> None:
    """Adam's moments, step count and the skip count from a converted JAX
    state: weights["exp_avg"][part] / ["exp_avg_sq"][part] are state dicts
    of the moments of models[key] (key "vq_<part>" or "<part>")."""
    optimizer.nonfinite_count = weights["nonfinite_count"]
    if weights["adam_step"] == 0:   # fresh: torch makes its moments lazily
        return
    for key, model in models.items():
        part = key.removeprefix("vq_")
        for name, p in model.named_parameters():
            optimizer.adam.state[p] = {
                "step": torch.tensor(float(weights["adam_step"])),
                "exp_avg": weights["exp_avg"][part][name].to(p.device).clone(),
                "exp_avg_sq": weights["exp_avg_sq"][part][name].to(p.device).clone()}


def _norm_buffers(models) -> list:
    return [b for m in models for mod in m.modules() if isinstance(mod, FlaxBatchNorm1d)
            for b in (mod.running_mean, mod.running_var)]


def _global(metrics: dict, mesh) -> dict:
    """The global values of this rank's metric terms (one all-reduce)."""
    return metrics if mesh is None else mesh.reduce_metrics(metrics)


def _restore(applied, buffers: list, saved: list) -> None:
    """Put back the BatchNorm statistics of a skipped step (JAX's
    tree_select): `applied` is the optimizer step's result, a 0-dim bool
    tensor (selected on the device, no host read) or a bool."""
    if applied is True:
        return
    with torch.no_grad():
        for b, s in zip(buffers, saved):
            if applied is False:
                b.copy_(s)
            else:
                torch.where(applied, b, s, out=b)


def _select(applied, new: vq_ops.VQState, old: vq_ops.VQState) -> vq_ops.VQState:
    """tree_select(applied, new, old) of a VQState, as `_restore` takes
    `applied`."""
    if isinstance(applied, bool):
        return new if applied else old
    return vq_ops.VQState(*(torch.where(applied, a, b) for a, b in zip(new, old)))


def recon_losses(recon: torch.Tensor, gt: torch.Tensor, mesh=None):
    """(L1 reconstruction, L1 velocity) of (B, T, C) poses (steps.py:78-81,
    :425-428); on a mesh, this rank's terms of the global means."""
    rec = global_mean(torch.abs(recon - gt), mesh)
    return rec, global_mean(torch.abs(torch.diff(recon, dim=1) - torch.diff(gt, dim=1)), mesh)


def part_losses(model: VQVAE, vq_state: vq_ops.VQState, gt: torch.Tensor, mesh=None):
    """One part's forward (steps.py:70-90) through a model in train mode:
    -> (rec, vel, commit, new VQState); the step's loss is rec + vel + commit
    summed over parts."""
    recon, commit, new_state, _ = model(gt, vq_state)
    rec, vel = recon_losses(recon, gt, mesh)
    return rec, vel, commit, new_state


def make_body_vq_step(vq_body: VQVAE, vq_hand: VQVAE, learning_rate: float = 1e-4,
                      code_num: int = 2048, rep6d: bool = False):
    """-> (init_state(generator, device), step(state, batch)).

    batch: {'poses': (B, T, 165) or the 129 conv channels; with rep6d (B, T,
    330) or the 258}.  step returns (state, metrics) with metrics
    {body,hand}_{rec,vel,commit} (0-dim tensors) and nonfinite_skips (the
    skip count after the step, a 0-dim int64 tensor)."""
    models = {"body": vq_body, "hand": vq_hand}
    slices = parts(rep6d)

    def init_state(generator: torch.Generator, device="cuda") -> BodyVQState:
        vq = {name: vq_ops.init_vq_state(generator, code_num, m.embedding_dim, device)
              for name, m in models.items()}
        for m in models.values():
            init_weights_(m, generator).to(device)
        params = [p for m in models.values() for p in m.parameters()]
        return BodyVQState(models, vq, SkipNonfiniteAdam(params, learning_rate))

    def step(state: BodyVQState, batch) -> tuple[BodyVQState, dict]:
        B, T = batch["poses"].shape[:2]
        with span("train_step", batch=B, frames=T):
            with span("forward"):
                conv = conv_channels(batch["poses"], rep6d)
                buffers = _norm_buffers(state.models.values())
                saved = [b.clone() for b in buffers]
                state.optimizer.zero_grad()
                total, metrics, new_vq = 0.0, {}, {}
                for name, sl in slices:
                    rec, vel, commit, new_vq[name] = part_losses(
                        state.models[name].train(), state.vq[name], conv[..., sl], state.mesh)
                    total = total + rec + vel + commit
                    metrics.update({f"{name}_rec": rec.detach(), f"{name}_vel": vel.detach(),
                                    f"{name}_commit": commit.detach()})
            with span("backward"):
                total.backward()
            metrics = _global(metrics, state.mesh)
            applied = state.optimizer.step()
            state.vq = {k: _select(applied, new_vq[k], state.vq[k]) for k in new_vq}
            _restore(applied, buffers, saved)
            state.step += 1
            metrics["nonfinite_skips"] = state.optimizer.nonfinite.clone()
            return state, metrics

    return init_state, step


def make_token_encoder(vq_body: VQVAE, vq_hand: VQVAE, frozen_vq_states: dict,
                       rep6d: bool = False):
    """poses -> (B, T/4, 2) int64 token grid through the FROZEN stage-1 VQs
    (eval mode, running statistics).  Deterministic given the poses."""
    (_, body), (_, hand) = parts(rep6d)

    @torch.no_grad()
    def encode(poses: torch.Tensor) -> torch.Tensor:
        conv = conv_channels(poses, rep6d)
        _, tb = vq_body.eval().encode(conv[..., body], frozen_vq_states["body"])
        _, th = vq_hand.eval().encode(conv[..., hand.start:], frozen_vq_states["hand"])
        return torch.stack([tb, th], dim=-1)

    return encode


# ---------------------------------------------------------------------------
# The body AE (the FGD feature net; nets/body_ae.py)
# ---------------------------------------------------------------------------

@dataclass
class BodyAEState:
    """Body-AE train state: the AE (parameters and BatchNorm statistics),
    the optimizer and the step."""
    model: AE
    optimizer: SkipNonfiniteAdam
    step: int = 0
    mesh: Any = None

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])

    @torch.no_grad()
    def load_converted(self, weights: dict) -> "BodyAEState":
        """Load `convert.from_jax_body_ae_state`'s output in place."""
        self.model.load_state_dict(weights["ae"])
        _load_adam(self.optimizer, {"ae": self.model}, weights)
        self.step = weights["step"]
        return self


def make_body_ae_step(ae: AE, learning_rate: float = 1e-4):
    """-> (init_state(generator, device), step(state, batch)).

    batch: {'poses': (B, T, 165) or the 129 conv channels}.  Loss: L1
    reconstruction + L1 velocity (body_ae.py:112-140); Adam with the
    non-finite skip, which also keeps the BatchNorm statistics of a skipped
    step, as JAX's tree_select.  Metrics: rec_loss, velocity_loss (0-dim
    tensors), nonfinite_skips (the skip count after the step, a 0-dim
    int64 tensor)."""

    def init_state(generator: torch.Generator, device="cuda") -> BodyAEState:
        init_weights_(ae, generator).to(device)
        return BodyAEState(ae, SkipNonfiniteAdam(ae.parameters(), learning_rate))

    def step(state: BodyAEState, batch) -> tuple[BodyAEState, dict]:
        gt = conv_channels(batch["poses"])
        buffers = _norm_buffers([state.model])
        saved = [b.clone() for b in buffers]
        state.optimizer.zero_grad()
        rec, vel = recon_losses(state.model.train()(gt), gt, state.mesh)
        (rec + vel).backward()
        metrics = _global({"rec_loss": rec.detach(), "velocity_loss": vel.detach()}, state.mesh)
        _restore(state.optimizer.step(), buffers, saved)
        state.step += 1
        return state, {**metrics, "nonfinite_skips": state.optimizer.nonfinite.clone()}

    return init_state, step


# ---------------------------------------------------------------------------
# Stage 2: the PixelCNN prior and the audio encoder (VQs frozen)
# ---------------------------------------------------------------------------

@dataclass
class PixelState:
    """Stage-2 train state: {'prior': GatedPixelCNN, 'audio': AudioEncoder}
    (parameters and the audio encoder's BatchNorm statistics), the
    optimizer and the step."""
    models: dict
    optimizer: SkipNonfiniteAdam
    step: int = 0
    mesh: Any = None

    def state_dict(self) -> dict:
        return {"models": {k: m.state_dict() for k, m in self.models.items()},
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for k, m in self.models.items():
            m.load_state_dict(sd["models"][k])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])

    @torch.no_grad()
    def load_converted(self, weights: dict) -> "PixelState":
        """Load `convert.from_jax_pixel_state`'s output in place."""
        for k, m in self.models.items():
            m.load_state_dict(weights[k])
        _load_adam(self.optimizer, self.models, weights)
        self.step = weights["step"]
        return self


def make_body_pixel_step(prior: GatedPixelCNN, audio_enc: AudioEncoder, vq_body: VQVAE,
                         vq_hand: VQVAE, frozen_vq_states: dict,
                         learning_rate: float = 1e-4, max_grad_norm: float = 5.0,
                         rep6d: bool = False):
    """-> (init_state(generator, device), step(state, batch, generator)).

    vq_body / vq_hand carry the frozen stage-1 weights and frozen_vq_states
    their {'body', 'hand'} VQStates; init_state moves them to the device.
    batch: 'aud_feat' (B, T, 64), 'speaker' (B,) and either 'tokens' (B,
    T/4, 2) (the trainer's cache; the frozen encode is skipped, which gives
    the same tokens) or 'poses' (B, T, 165 or 129 conv channels; with rep6d
    330 or 258, as `make_token_encoder`); optional
    'aud_keep' (B, T/4) bool, the audio dropout's keep mask, else drawn from
    `generator`.  Metrics: ce_loss and grad (the gradients' global norm
    before the clip; 0-dim tensors), nonfinite_skips (the skip count after
    the step, a 0-dim int64 tensor)."""
    models = {"prior": prior, "audio": audio_enc}
    encode = make_token_encoder(vq_body, vq_hand, frozen_vq_states, rep6d)

    def init_state(generator: torch.Generator, device="cuda") -> PixelState:
        for m in models.values():
            init_weights_(m, generator).to(device)
        vq_body.to(device)
        vq_hand.to(device)
        frozen_vq_states.update({k: s.to(device) for k, s in frozen_vq_states.items()})
        params = [p for m in models.values() for p in m.parameters()]
        return PixelState(models, SkipNonfiniteAdam(params, learning_rate, max_grad_norm))

    def step(state: PixelState, batch, generator: torch.Generator | None = None):
        B, T = batch["aud_feat"].shape[:2]
        with span("train_step", batch=B, frames=T):
            with span("forward"):
                tokens = batch.get("tokens")
                if tokens is None:
                    tokens = encode(batch["poses"])
                tokens = tokens.long()
                B, H = tokens.shape[:2]
                keep = batch.get("aud_keep")
                if keep is None:
                    if generator is None:
                        raise ValueError("the body-pixel step draws its audio dropout from a "
                                         "generator: pass one, or batch['aud_keep']")
                    # drawn for the global batch; this rank keeps its rows
                    dp, rank = ((1, 0) if state.mesh is None
                                else (state.mesh.dp, state.mesh.dp_rank))
                    keep = draw_aud_keep(B * dp, H, generator, tokens.device)[
                        rank * B:(rank + 1) * B]
                buffers = _norm_buffers([state.models["audio"]])
                saved = [b.clone() for b in buffers]
                opt = state.optimizer
                opt.zero_grad()
                feat = state.models["audio"].train()(batch["aud_feat"])
                logits = state.models["prior"].train()(tokens, batch["speaker"].long(), feat,
                                                        keep)
                flat = logits.reshape(-1, logits.shape[-1]).float()
                ce = global_mean(F.cross_entropy(flat, tokens.reshape(-1), reduction="none"),
                                 state.mesh)
            with span("backward"):
                ce.backward()
            with span("optimizer"):      # the clip's norm, also reported as a metric
                norm = opt.grad_norm()
            metrics = _global({"ce_loss": ce.detach()}, state.mesh)
            _restore(opt.step(norm), buffers, saved)
            state.step += 1
            return state, {**metrics, "grad": norm.detach(),
                           "nonfinite_skips": opt.nonfinite.clone()}

    return init_state, step


# ---------------------------------------------------------------------------
# Stage 3: the face generator (SGD, wav2vec conv extractor frozen)
# ---------------------------------------------------------------------------

@dataclass
class FaceState:
    """Stage-3 train state: the face generator (its conv extractor frozen:
    requires_grad off, no optimizer state), the optimizer of the rest and
    the step.  `tables`: K3's tables of the frozen extractor, packed on
    first use after each weight load: f32, or bf16 when the wav2vec
    config computes in bf16 (`--bf16`), the tables inference uses.  On a
    tp mesh the extractor stays whole, so the tables are whole on every
    rank."""
    face: FaceGenerator
    optimizer: SkipNonfiniteSGD
    step: int = 0
    _tables: dict | None = None
    mesh: Any = None

    @property
    def tables(self) -> dict:
        if self._tables is None:
            enc = self.face.audio_encoder
            self._tables = pack_extractor_tables(enc.feature_extractor,
                                                 enc.cfg.dtype or torch.float32)
        return self._tables

    def state_dict(self) -> dict:
        return {"face": self.face.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.face.load_state_dict(sd["face"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self._tables = None

    @torch.no_grad()
    def load_converted(self, weights: dict) -> "FaceState":
        """Load `convert.from_jax_face_state`'s output in place: the same
        parameters, SGD momentum and counts as the JAX state."""
        self.face.load_state_dict(weights["face"])
        sgd = self.optimizer.inner
        for name, p in self.face.named_parameters():
            if p.requires_grad:
                sgd.state[p] = {"momentum_buffer": weights["trace"][name].to(p.device).clone()}
        self.optimizer.nonfinite_count = weights["nonfinite_count"]
        self.step = weights["step"]
        self._tables = None
        return self


def face_losses(pred: torch.Tensor, gt: torch.Tensor, valid_frames=None, mesh=None):
    """(L1 of the first 6 channels, MSE of the last 100), means over every
    frame, or over real frames only when valid_frames (B,) is given
    (steps.py:287-297); on a mesh, this rank's terms of the global means
    (the real frames counted over every dp rank)."""
    d6, d100 = pred[..., :6] - gt[..., :6], pred[..., -100:] - gt[..., -100:]
    if valid_frames is None:
        return global_mean(d6.abs(), mesh), global_mean(d100 * d100, mesh)
    m = (torch.arange(gt.shape[1], device=gt.device)[None, :, None]
         < valid_frames.to(gt.device)[:, None, None]).to(pred.dtype)
    n = m.sum()
    if mesh is not None:
        n = mesh.dp_sum_(n)
    return (d6.abs() * m).sum() / (n * 6), (d100 * d100 * m).sum() / (n * 100)


def draw_face_masks(B: int, T: int, width: int, generator: torch.Generator, device,
                    mesh=None, spec=None, keep=None) -> tuple:
    """The stochastic face step's SpecAugment starts (B, num_masks) and
    dropout keep mask (B, T, width) of this rank's B rows: each one not
    given is drawn (starts first) for the global batch of B x dp rows, as
    JAX draws for the global batch shape (steps.py:266-273), and sliced to
    this dp rank's rows."""
    dp, rank = (1, 0) if mesh is None else (mesh.dp, mesh.dp_rank)
    rows = slice(rank * B, (rank + 1) * B)
    if spec is None:
        spec = draw_spec_starts(B * dp, T, generator, device)[rows]
    if keep is None:
        keep = draw_drop_keep((B * dp, T, width), generator, device)[rows]
    return spec, keep


def make_face_step(face: FaceGenerator, learning_rate: float = 1e-3, momentum: float = 0.9,
                   max_grad_norm: float = 5.0, stochastic: bool = True):
    """-> (init_state(generator, device), step(state, batch, generator)).

    batch: 'waveform' (B, N), 'id_onehot' (B, classes), 'gt' (B, T, >= 106);
    optional 'valid_samples' / 'valid_frames' (B,) for length-bucketed
    batches; in stochastic mode optional 'spec_starts' (B, num_masks) and
    'drop_keep' (B, T, 256) bool, else drawn from `generator`
    (`draw_face_masks`).  On a mesh these are this rank's rows of the
    global batch.  stochastic=False turns dropout and SpecAugment off, as in
    JAX.  Metrics: MSELoss (the L1 term, the reference's name), exp_loss,
    loss, grad (the global norm before the clip; 0-dim tensors; global on a
    mesh), nonfinite_skips (the skip count after the step, a 0-dim int64
    tensor)."""

    def init_state(generator: torch.Generator, device="cuda") -> FaceState:
        init_weights_(face, generator)
        enc = face.audio_encoder
        with torch.no_grad():
            enc.masked_spec_embed.copy_(torch.rand(enc.masked_spec_embed.shape,
                                                   generator=generator))
        enc.feature_extractor.requires_grad_(False)
        face.to(device)
        params = [p for p in face.parameters() if p.requires_grad]
        return FaceState(face, SkipNonfiniteSGD(params, learning_rate, momentum, max_grad_norm))

    def step(state: FaceState, batch, generator: torch.Generator | None = None):
        gt = batch["gt"]
        B, T = gt.shape[:2]
        vs, vf = batch.get("valid_samples"), batch.get("valid_frames")
        spec = keep = None
        if stochastic:
            spec, keep = batch.get("spec_starts"), batch.get("drop_keep")
            if generator is None and (spec is None or keep is None):
                raise ValueError("the stochastic face step draws SpecAugment and dropout from "
                                 "a generator: pass one, or batch['spec_starts'] and "
                                 "batch['drop_keep']")
            spec, keep = draw_face_masks(B, T, face.audio_feature_map.out_features, generator,
                                         gt.device, state.mesh, spec, keep)
        model = state.face.train()
        feats = frozen_features(model.audio_encoder, batch["waveform"], vs, tables=state.tables)
        opt = state.optimizer
        opt.zero_grad()
        pred = model.train_forward(feats, batch["id_onehot"], T, vs, vf, spec, keep)
        l1, mse = face_losses(pred, gt, vf, state.mesh)
        loss = l1 + mse
        loss.backward()
        norm = opt.grad_norm()
        metrics = _global({"MSELoss": l1.detach(), "exp_loss": mse.detach(),
                           "loss": loss.detach()}, state.mesh)
        opt.step(norm)
        state.step += 1
        return state, {**metrics, "grad": norm.detach(), "nonfinite_skips": opt.nonfinite.clone()}

    return init_state, step


# ---------------------------------------------------------------------------
# The LS3DCG baseline: two optimizers, one adversarial step
# ---------------------------------------------------------------------------

@dataclass
class LS3DCGState:
    """LS3DCG train state: {'gen': LS3DCGGenerator, 'disc':
    LS3DCGDiscriminator} (parameters and BatchNorm statistics), one
    optimizer each under the same keys, and the step."""
    models: dict
    optimizers: dict
    step: int = 0
    mesh: Any = None

    def state_dict(self) -> dict:
        return {"models": {k: m.state_dict() for k, m in self.models.items()},
                "optimizers": {k: o.state_dict() for k, o in self.optimizers.items()},
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        for k, m in self.models.items():
            m.load_state_dict(sd["models"][k])
            self.optimizers[k].load_state_dict(sd["optimizers"][k])
        self.step = int(sd["step"])

    @torch.no_grad()
    def load_converted(self, weights: dict) -> "LS3DCGState":
        """Load `convert.from_jax_ls3dcg_state`'s output in place."""
        for k, m in self.models.items():
            m.load_state_dict(weights[k])
            _load_adam(self.optimizers[k], {k: m}, weights["adam"][k])
        self.step = weights["step"]
        return self


def make_ls3dcg_step(gen: LS3DCGGenerator, disc: LS3DCGDiscriminator,
                     learning_rate: float = 1e-4, keypoint_w: float = 1.0, gan_w: float = 1.0):
    """-> (init_state(generator, device), step(state, batch)): the LSGAN step
    of nets/LS3DCG.py:280-363, as JAX's (steps.py:322-404).

    batch: 'poses' (B, T, 165, or the 129 conv channels), 'expression'
    (B, T, 100), 'aud_feat' (B, T, 64).  In order:
    - the generator in eval mode (running statistics), detached;
    - the discriminator in train mode on [gt conv | aud] then on [pred conv |
      aud], its batch statistics chaining from the first call into the
      second; D loss mean((real - 1)^2) + mean(fake^2); Adam;
    - the generator in train mode; L1 jaw + MSE expression + L1 body + L1
      hand, weighted by keypoint_w, plus gan_w mean((D(pred) - 1)^2) with
      the refreshed discriminator in eval mode (its new parameters and
      statistics; no gradient of its own); Adam.
    A model whose gradients are not all finite keeps its parameters, Adam
    state and BatchNorm statistics (JAX's tree_select).  Metrics: jaw_loss,
    face_loss, body_loss, hand_loss, gen, dis (0-dim tensors) and
    nonfinite_skips, the two optimizers' counts summed."""
    models = {"gen": gen, "disc": disc}

    def init_state(generator: torch.Generator, device="cuda") -> LS3DCGState:
        for m in models.values():
            init_weights_(m, generator).to(device)
        return LS3DCGState(models, {k: SkipNonfiniteAdam(m.parameters(), learning_rate)
                                    for k, m in models.items()})

    def step(state: LS3DCGState, batch) -> tuple[LS3DCGState, dict]:
        g, d = state.models["gen"], state.models["disc"]
        g_opt, d_opt = state.optimizers["gen"], state.optimizers["disc"]
        poses, aud = batch["poses"], batch["aud_feat"]
        conv = conv_channels(poses)
        # the discriminator, against a detached eval-mode generator
        with torch.no_grad():
            pred = g.eval()(aud)
        d_buffers = _norm_buffers([d])
        d_saved = [b.clone() for b in d_buffers]
        d_opt.zero_grad()
        d.train()
        real = d(torch.cat([conv, aud], dim=-1))
        fake = d(torch.cat([pred[..., 103:], aud], dim=-1))
        mesh = state.mesh
        d_loss = global_mean((real - 1.0) ** 2, mesh) + global_mean(fake ** 2, mesh)
        d_loss.backward()
        _restore(d_opt.step(), d_buffers, d_saved)
        # the generator, against the refreshed discriminator in eval mode
        g_buffers = _norm_buffers([g])
        g_saved = [b.clone() for b in g_buffers]
        g_opt.zero_grad()
        pred = g.train()(aud)
        jaw_loss = global_mean(torch.abs(pred[..., :3] - poses[..., :3]), mesh)
        face_loss = global_mean((pred[..., 3:103] - batch["expression"]) ** 2, mesh)
        body_loss = global_mean(torch.abs(pred[..., 103:142] - conv[..., :BODY_DIM]), mesh)
        hand_loss = global_mean(torch.abs(pred[..., 142:] - conv[..., BODY_DIM:]), mesh)
        l1 = jaw_loss + face_loss + body_loss + hand_loss
        d.eval().requires_grad_(False)
        try:
            gen_err = global_mean((d(torch.cat([pred[..., 103:], aud], dim=-1)) - 1.0) ** 2, mesh)
            (keypoint_w * l1 + gan_w * gen_err).backward()
        finally:
            d.requires_grad_(True)
        _restore(g_opt.step(), g_buffers, g_saved)
        state.step += 1
        metrics = {"jaw_loss": jaw_loss, "face_loss": face_loss, "body_loss": body_loss,
                   "hand_loss": hand_loss, "gen": gen_err, "dis": d_loss}
        metrics = _global({k: v.detach() for k, v in metrics.items()}, mesh)
        metrics["nonfinite_skips"] = g_opt.nonfinite + d_opt.nonfinite
        return state, metrics

    return init_state, step

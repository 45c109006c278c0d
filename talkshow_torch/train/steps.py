"""Train steps of the port (talkshow_tpu/train/steps.py).

Stage 1 (`make_body_vq_step`, steps.py:35-107): the compositional body and
hand VQ-VAEs, losses as the reference (smplx_body_vq.py:177-206): per part
L1 reconstruction + L1 velocity + commitment, summed; Adam with the
non-finite skip.  `make_token_encoder` (steps.py:121-142) is the frozen-VQ
encode that feeds prior training.  On the card each VQ-VAE forward runs K4
once (`ops/vq.nearest_code`).

Unlike the JAX package, where the state is an immutable pytree, the state
here holds the modules (parameters and BatchNorm statistics) and the
optimizer, and a step updates them in place.  The 6-D pose variant
(`rep6d`) and the other stages wait (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from talkshow_torch.models.layers import FlaxBatchNorm1d, init_weights_
from talkshow_torch.models.vqvae import VQVAE
from talkshow_torch.ops import vq as vq_ops
from talkshow_torch.ops.pose import BODY_DIM, C_INDEX_3D, FULL_POSE_DIM, HAND_DIM
from talkshow_torch.train.optim import SkipNonfiniteAdam

PARTS = (("body", slice(0, BODY_DIM)), ("hand", slice(BODY_DIM, BODY_DIM + HAND_DIM)))


def conv_channels(poses: torch.Tensor) -> torch.Tensor:
    """(B, T, 165) poses -> the 129 conv channels; 129-wide poses pass."""
    if poses.shape[-1] != FULL_POSE_DIM:
        return poses
    return poses[..., torch.as_tensor(C_INDEX_3D, device=poses.device)]


@dataclass
class BodyVQState:
    """Stage-1 train state: the VQ-VAEs {'body', 'hand'} (their parameters
    and BatchNorm statistics), their VQStates, the optimizer and the step."""
    models: dict
    vq: dict
    optimizer: SkipNonfiniteAdam
    step: int = 0

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
        adam = self.optimizer.adam
        for part, model in self.models.items():
            model.load_state_dict(weights[f"vq_{part}"])
            self.vq[part] = weights[f"vq_{part}_state"].to(dev)
            if weights["adam_step"] == 0:
                continue
            for name, p in model.named_parameters():
                adam.state[p] = {
                    "step": torch.tensor(float(weights["adam_step"])),
                    "exp_avg": weights["exp_avg"][part][name].to(dev).clone(),
                    "exp_avg_sq": weights["exp_avg_sq"][part][name].to(dev).clone()}
        self.optimizer.nonfinite_count = weights["nonfinite_count"]
        self.step = weights["step"]
        return self


def _norm_buffers(models) -> list:
    return [b for m in models for mod in m.modules() if isinstance(mod, FlaxBatchNorm1d)
            for b in (mod.running_mean, mod.running_var)]


def part_losses(model: VQVAE, vq_state: vq_ops.VQState, gt: torch.Tensor):
    """One part's forward (steps.py:70-90) through a model in train mode:
    -> (rec, vel, commit, new VQState); the step's loss is rec + vel + commit
    summed over parts."""
    recon, commit, new_state, _ = model(gt, vq_state)
    rec = torch.mean(torch.abs(recon - gt))
    vel = torch.mean(torch.abs((recon[:, 1:] - recon[:, :-1]) - (gt[:, 1:] - gt[:, :-1])))
    return rec, vel, commit, new_state


def make_body_vq_step(vq_body: VQVAE, vq_hand: VQVAE, learning_rate: float = 1e-4,
                      code_num: int = 2048):
    """-> (init_state(generator, device), step(state, batch)).

    batch: {'poses': (B, T, 165) or the 129 conv channels}.  step returns
    (state, metrics) with metrics {body,hand}_{rec,vel,commit} (0-dim
    tensors) and nonfinite_skips (int)."""
    models = {"body": vq_body, "hand": vq_hand}

    def init_state(generator: torch.Generator, device="cuda") -> BodyVQState:
        vq = {name: vq_ops.init_vq_state(generator, code_num, m.embedding_dim, device)
              for name, m in models.items()}
        for m in models.values():
            init_weights_(m, generator).to(device)
        params = [p for m in models.values() for p in m.parameters()]
        return BodyVQState(models, vq, SkipNonfiniteAdam(params, learning_rate))

    def step(state: BodyVQState, batch) -> tuple[BodyVQState, dict]:
        conv = conv_channels(batch["poses"])
        buffers = _norm_buffers(state.models.values())
        saved = [b.clone() for b in buffers]
        state.optimizer.zero_grad()
        total, metrics, new_vq = 0.0, {}, {}
        for name, sl in PARTS:
            rec, vel, commit, new_vq[name] = part_losses(state.models[name].train(),
                                                         state.vq[name], conv[..., sl])
            total = total + rec + vel + commit
            metrics.update({f"{name}_rec": rec.detach(), f"{name}_vel": vel.detach(),
                            f"{name}_commit": commit.detach()})
        total.backward()
        if state.optimizer.step():
            state.vq = new_vq
        else:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
        state.step += 1
        metrics["nonfinite_skips"] = state.optimizer.nonfinite_count
        return state, metrics

    return init_state, step


def make_token_encoder(vq_body: VQVAE, vq_hand: VQVAE, frozen_vq_states: dict):
    """poses -> (B, T/4, 2) int64 token grid through the FROZEN stage-1 VQs
    (eval mode, running statistics).  Deterministic given the poses."""

    @torch.no_grad()
    def encode(poses: torch.Tensor) -> torch.Tensor:
        conv = conv_channels(poses)
        _, tb = vq_body.eval().encode(conv[..., :BODY_DIM], frozen_vq_states["body"])
        _, th = vq_hand.eval().encode(conv[..., BODY_DIM:], frozen_vq_states["hand"])
        return torch.stack([tb, th], dim=-1)

    return encode

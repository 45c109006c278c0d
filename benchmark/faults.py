"""Faults planted in the program, for the tests that see `correct` come out
false and for the chip readings that set the limits' upper ends
(`python -m benchmark.calibrate --fault <name>`).  Each `plant(name)`
replaces one attribute of the program and returns the function that puts
it back."""
from __future__ import annotations


def _swap(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return lambda: setattr(owner, attr, orig)


def _alter_token(orig):
    def fault(*args, **kwargs):
        tokens = orig(*args, **kwargs).clone()
        mid = tokens.shape[1] // 2
        tokens[:, mid, 0] = (tokens[:, mid, 0] + 1) % args[0].input_dim
        return tokens
    return fault


def _half_decode(orig):
    def fault(model, label, audio, **kwargs):
        B = audio.shape[0]
        h = max(1, B // 2)
        noise = kwargs.pop("noise", None)
        sub = orig(model, label[:h], audio[:h],
                   noise=None if noise is None else noise[:, :, :h].contiguous(), **kwargs)
        return sub.repeat((B + h - 1) // h, 1, 1)[:B]
    return fault


def _half_mean(orig):
    def fault(x, mesh=None):
        return orig(x[: max(1, x.shape[0] // 2)], mesh)
    return fault


def _frozen_step(orig):
    def fault(self, norm=None):
        return True
    return fault


def _shift(delta):
    def make(orig):
        def fault(*args, **kwargs):
            return orig(*args, **kwargs) + delta
        return fault
    return make


def plant(name: str):
    """Faults: token (one token a decode altered where K1 produces it),
    half_decode (half the sample batch decoded, the rest repeated),
    half_batch (a training loss's mean taken over half the batch's rows),
    frozen (the optimizer step applies nothing: the state comes back
    unchanged), face (the face stage's answer shifted), body (the VQ
    decoders' answer shifted)."""
    import talkshow_torch.models.body as body
    import talkshow_torch.train.steps as steps
    from talkshow_torch.models.vqvae import VQVAE
    from talkshow_torch.pipeline import Pipeline
    from talkshow_torch.train.optim import SkipNonfinite
    table = {
        "token": (body, "sample_tokens_fused", _alter_token),
        "half_decode": (body, "sample_tokens_fused", _half_decode),
        "half_batch": (steps, "global_mean", _half_mean),
        "frozen": (SkipNonfinite, "step", _frozen_step),
        "face": (Pipeline, "face_stage", _shift(0.01)),
        "body": (VQVAE, "decode_latents", _shift(0.05)),
    }
    return _swap(*table[name])

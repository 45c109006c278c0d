"""Weights of the JAX package -> state dicts of the port.

`from_jax(face_vars, body_vars)` takes the flax variable trees of a
talkshow_tpu Pipeline as numpy arrays (the caller runs
``jax.tree.map(np.asarray, tree)``; this module imports no JAX) and returns
the port's state dicts and VQStates, ready for `Pipeline.load_converted`.

It inverts the torch -> flax layout mapping of
talkshow_tpu/convert/talkshow.py:107-296 and convert/wav2vec.py:
  flax Conv (k, in, out)             -> torch Conv1d (out, in, k)
  flax ConvTranspose (k, out, in)    -> torch ConvTranspose1d (in, out, k)
  flax Conv2d (kh, kw, in, out)      -> torch Conv2d (out, in, kh, kw)
  flax 1x1 Conv2d / Dense (.., in, out) -> torch Linear (out, in)
  flax attention (C, heads, hd) / (heads, hd, C) -> torch Linear (C, C)
  scale/mean/var                      -> weight/running_mean/running_var
"""
from __future__ import annotations

import re

import numpy as np
import torch

from talkshow_torch.ops.vq import VQState


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _rename(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


_LEAF = [(r"\.scale$", ".weight"), (r"\.kernel$", ".weight"),
         (r"\.embedding$", ".weight"), (r"\.mean$", ".running_mean"),
         (r"\.var$", ".running_var")]


def _kernel(a: np.ndarray) -> np.ndarray:
    """flax kernel -> torch weight (Dense, Conv1d/ConvTranspose1d, Conv2d)."""
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def _convert(variables: dict, rules, skip=(), special=None) -> dict:
    sd = {}
    for col in ("params", "batch_stats"):
        for key, a in _flat(variables.get(col, {})).items():
            if any(key.startswith(s) for s in skip):
                continue
            out = special(key, a) if special else None
            if out is None:
                name = _rename(key, rules + _LEAF)
                out = {name: _kernel(a) if key.endswith(".kernel") else a}
            for name, arr in out.items():
                sd[name] = torch.tensor(np.asarray(arr, np.float32))
    return sd


_CONV_STACK = [(r"\b(enc|dec|up|down)_(\d)\b", r"_\1_\2"),
               (r"\blayer_(\d+)\b", r"_layers.\1"),
               (r"\b(ConvTranspose_0|Conv_0)\b", "conv"),
               (r"\bTorchBatchNorm_0\.BatchNorm_0\b", "norm"),
               (r"\bnorm\.BatchNorm_0\b", "norm")]


def convert_vqvae(variables: dict) -> dict:
    """flax VQVAE variables -> port VQVAE state dict (encoder and decoder).
    Also maps an Adam moment tree shaped like the params: pass it as
    {"params": tree}."""
    return _convert(variables, _CONV_STACK)


def convert_audio_encoder(variables: dict) -> dict:
    return _convert(variables, _CONV_STACK)


_LINEAR_1X1 = ("vert_to_horiz", "horiz_resid", "embedding_aud", "fusion_v",
               "fusion_h", "out_hidden", "out_logits")


def convert_pixelcnn(variables: dict) -> dict:
    def special(key, a):
        if key.endswith(".kernel") and key.split(".")[-2] in _LINEAR_1X1:
            return {_rename(key, rules + _LEAF): a[0, 0].T}
        return None

    rules = [(r"\blayer_(\d+)\b", r"layers.\1"),
             (r"\bclass_embed\b", "class_cond_embedding")]
    return _convert(variables, rules, special=special)


_FACE = [(r"feature_extractor\.conv_(\d+)", r"feature_extractor.conv_layers.\1.conv"),
         (r"feature_extractor\.group_norm", "feature_extractor.conv_layers.0.layer_norm"),
         (r"audio_encoder\.pos_conv_embed", "audio_encoder.encoder.pos_conv_embed"),
         (r"audio_encoder\.encoder_layer_norm", "audio_encoder.encoder.layer_norm"),
         (r"audio_encoder\.layers_(\d+)", r"audio_encoder.encoder.layers.\1"),
         (r"\bffn_intermediate\b", "feed_forward.intermediate_dense"),
         (r"\bffn_output\b", "feed_forward.output_dense"),
         (r"first_net\.conv_(\d+)", r"first_net.conv_layers.\1"),
         (r"\b(jaw|exp)_cnr_(\d+)\b", r"\1_cnr.\2"),
         (r"\bConv_0\b", "conv"), (r"\bLayerNorm_0\b", "norm")]
_ATTN = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}


def convert_face(variables: dict) -> dict:
    """flax FaceGenerator variables -> port FaceGenerator state dict."""
    def special(key, a):
        m = re.search(r"\.attention\.(query|key|value|out)\.(kernel|bias)$", key)
        if m is None:
            return None
        proj, leaf = m.groups()
        name = _rename(key[: m.start()], _FACE) + f".attention.{_ATTN[proj]}."
        if leaf == "bias":
            return {name + "bias": a.reshape(-1)}
        w = a.reshape(-1, a.shape[-1]) if proj == "out" else a.reshape(a.shape[0], -1)
        return {name + "weight": w.T}

    return _convert(variables, _FACE, skip=("audio_encoder.masked_spec_embed",),
                    special=special)


def _vq_state(state) -> VQState:
    return VQState(*(torch.tensor(np.asarray(getattr(state, f)))
                     for f in VQState._fields))


def from_jax_body_vq_state(state) -> dict:
    """A JAX `train.steps.BodyVQState` (numpy leaves) -> the port's stage-1
    state, for `train.steps.BodyVQState.load_converted`.

    Returns {"vq_body", "vq_hand": VQVAE state dicts (params + BatchNorm
    statistics), "vq_body_state", "vq_hand_state": VQState, "exp_avg",
    "exp_avg_sq": {"body", "hand": state dicts of the Adam moments},
    "adam_step": optax's count, "nonfinite_count", "step": ints}."""
    adam = next(s for s in state.opt_state["inner"] if hasattr(s, "mu"))
    out = {"adam_step": int(np.asarray(adam.count)),
           "nonfinite_count": int(np.asarray(state.opt_state["nonfinite_count"])),
           "step": int(np.asarray(state.step)),
           "exp_avg": {}, "exp_avg_sq": {}}
    for part in ("body", "hand"):
        out[f"vq_{part}"] = convert_vqvae({"params": state.params[part],
                                           "batch_stats": state.batch_stats[part]})
        out[f"vq_{part}_state"] = _vq_state(state.vq[part])
        out["exp_avg"][part] = convert_vqvae({"params": adam.mu[part]})
        out["exp_avg_sq"][part] = convert_vqvae({"params": adam.nu[part]})
    return out


def from_jax(face_vars: dict, body_vars: dict) -> dict:
    """Flax trees (numpy leaves) -> the port's weights.

    face_vars: the JAX Pipeline's `face_vars`; body_vars: a dict with the
    JAX BodyModels fields vq_body_vars, vq_hand_vars, vq_body_state,
    vq_hand_state, audio_enc_vars and prior_vars (the JAX Pipeline's
    `_body_arrays`).  Returns {"face", "vq_body", "vq_hand", "audio_enc",
    "prior": state dicts, "vq_body_state", "vq_hand_state": VQState}."""
    return {
        "face": convert_face(face_vars),
        "vq_body": convert_vqvae(body_vars["vq_body_vars"]),
        "vq_hand": convert_vqvae(body_vars["vq_hand_vars"]),
        "audio_enc": convert_audio_encoder(body_vars["audio_enc_vars"]),
        "prior": convert_pixelcnn(body_vars["prior_vars"]),
        "vq_body_state": _vq_state(body_vars["vq_body_state"]),
        "vq_hand_state": _vq_state(body_vars["vq_hand_state"]),
    }

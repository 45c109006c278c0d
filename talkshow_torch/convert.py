"""Weights of the JAX package, and the reference's .pth checkpoints ->
state dicts of the port.

`from_jax(face_vars, body_vars[, ae_vars])` takes the flax variable trees
of a talkshow_tpu Pipeline (and of the body AE, the FGD feature net) as
numpy arrays (the caller runs ``jax.tree.map(np.asarray, tree)``; this
module imports no JAX) and returns the port's state dicts and VQStates,
ready for `Pipeline.load_converted` (and `AE.load_state_dict`).
`convert_ls3dcg` maps the LS3DCG generator's and discriminator's trees,
and the `from_jax_*_state` functions carry a JAX train state (parameters,
statistics, optimizer moments, counts) into the port's, stage by stage.

It inverts the torch -> flax layout mapping of
talkshow_tpu/convert/talkshow.py:107-296 and convert/wav2vec.py:
  flax Conv (k, in, out)             -> torch Conv1d (out, in, k)
  flax ConvTranspose (k, out, in)    -> torch ConvTranspose1d (in, out, k)
  flax Conv2d (kh, kw, in, out)      -> torch Conv2d (out, in, kh, kw)
  flax 1x1 Conv2d / Dense (.., in, out) -> torch Linear (out, in)
  flax attention (C, heads, hd) / (heads, hd, C) -> torch Linear (C, C)
  scale/mean/var                      -> weight/running_mean/running_var

The second half reads the reference TalkSHOW trainer's checkpoints (a
torch-layout copy of what talkshow_tpu/convert/talkshow.py:27-304 reads):
`reference_face`, `reference_body_vq`, `reference_body_pixel` and
`reference_body_ae` take the loaded `.pth` object and return the port's
state dicts, which `Pipeline.from_torch_checkpoints` (and `AE`) load
strictly.  The port keeps the
reference's parameter names, so most keys pass unchanged; what differs is
DataParallel's `module.` prefixes, the Trainer nesting, the face heads'
names, the weight-normed positional conv, the PixelCNN's 1x1 convs (the
port's `nn.Linear`) and mask-A's zeroed kernel row and column, which the
port leaves out.  `config_from_hf` maps Hugging Face `Wav2Vec2Config`
fields (an object or a plain dict) to the port's config without
importing `transformers`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from talkshow_torch.models.wav2vec import Wav2Vec2Config
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


def convert_ae(variables: dict) -> dict:
    """flax AE variables -> port AE state dict (the VQVAE's names, no
    quantizer).  Also maps an Adam moment tree: pass {"params": tree}."""
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

    return _convert(variables, _FACE, special=special)


def convert_ls3dcg(variables: dict) -> dict:
    """flax LS3DCGGenerator or LS3DCGDiscriminator variables (params and
    batch_stats) -> the port's state dict of that module.  Also maps an Adam
    moment tree shaped like the params: pass it as {"params": tree}."""
    return _convert(variables, _CONV_STACK)


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


def _find(tree, field: str):
    """The first node of an optax state (nested tuples, named tuples and
    dicts) that has `field`."""
    if hasattr(tree, field):
        return tree
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find(child, field)
        if found is not None:
            return found
    return None


def from_jax_pixel_state(state) -> dict:
    """A JAX `train.steps.PixelState` (numpy leaves) -> the port's stage-2
    state, for `train.steps.PixelState.load_converted`.

    Returns {"prior": GatedPixelCNN state dict, "audio": AudioEncoder state
    dict (params + BatchNorm statistics), "exp_avg", "exp_avg_sq":
    {"prior", "audio": state dicts of the Adam moments}, "adam_step":
    optax's count, "nonfinite_count", "step": ints}."""
    adam = _find(state.opt_state["inner"], "mu")
    out = {"prior": convert_pixelcnn({"params": state.params["prior"]}),
           "audio": convert_audio_encoder({"params": state.params["audio"],
                                           "batch_stats": state.batch_stats["audio"]}),
           "adam_step": int(np.asarray(adam.count)),
           "nonfinite_count": int(np.asarray(state.opt_state["nonfinite_count"])),
           "step": int(np.asarray(state.step))}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        out[key] = {"prior": convert_pixelcnn({"params": tree["prior"]}),
                    "audio": convert_audio_encoder({"params": tree["audio"]})}
    return out


def from_jax_face_state(state) -> dict:
    """A JAX `train.steps.FaceState` (numpy leaves) -> the port's stage-3
    state, for `train.steps.FaceState.load_converted`.

    Returns {"face": FaceGenerator state dict, "trace": state dict of the
    SGD momentum of the trained partition (the frozen extractor has none),
    "nonfinite_count", "step": ints}."""
    trace = dict(_find(state.opt_state["inner"], "trace").trace)
    trace["audio_encoder"] = {k: v for k, v in trace["audio_encoder"].items()
                              if k != "feature_extractor"}
    return {"face": convert_face({"params": state.params}),
            "trace": convert_face({"params": trace}),
            "nonfinite_count": int(np.asarray(state.opt_state["nonfinite_count"])),
            "step": int(np.asarray(state.step))}


def _adam_of(opt_state, part: str, convert_fn) -> dict:
    """One model's `skip_nonfinite_updates(adam)` state -> {"exp_avg",
    "exp_avg_sq": {part: state dicts of the moments}, "adam_step",
    "nonfinite_count"}, the layout `train.steps._load_adam` reads."""
    adam = _find(opt_state["inner"], "mu")
    return {"exp_avg": {part: convert_fn({"params": adam.mu})},
            "exp_avg_sq": {part: convert_fn({"params": adam.nu})},
            "adam_step": int(np.asarray(adam.count)),
            "nonfinite_count": int(np.asarray(opt_state["nonfinite_count"]))}


def from_jax_body_ae_state(state) -> dict:
    """A JAX `train.steps.BodyAEState` (numpy leaves) -> the port's body-AE
    state, for `train.steps.BodyAEState.load_converted`.

    Returns {"ae": AE state dict (params + BatchNorm statistics),
    "exp_avg", "exp_avg_sq": {"ae": state dicts of the Adam moments},
    "adam_step": optax's count, "nonfinite_count", "step": ints}."""
    return {"ae": convert_ae({"params": state.params, "batch_stats": state.batch_stats}),
            **_adam_of(state.opt_state, "ae", convert_ae),
            "step": int(np.asarray(state.step))}


def from_jax_ls3dcg_state(state) -> dict:
    """A JAX `train.steps.LS3DCGState` (numpy leaves) -> the port's LS3DCG
    state, for `train.steps.LS3DCGState.load_converted`.

    Returns {"gen", "disc": state dicts (params + BatchNorm statistics),
    "adam": {"gen", "disc": each model's Adam moments, optax's count and
    its skip count}, "step": int}."""
    return {"gen": convert_ls3dcg({"params": state.g_params, "batch_stats": state.g_stats}),
            "disc": convert_ls3dcg({"params": state.d_params, "batch_stats": state.d_stats}),
            "adam": {"gen": _adam_of(state.g_opt, "gen", convert_ls3dcg),
                     "disc": _adam_of(state.d_opt, "disc", convert_ls3dcg)},
            "step": int(np.asarray(state.step))}


def from_jax(face_vars: dict, body_vars: dict, ae_vars: dict | None = None) -> dict:
    """Flax trees (numpy leaves) -> the port's weights.

    face_vars: the JAX Pipeline's `face_vars`; body_vars: a dict with the
    JAX BodyModels fields vq_body_vars, vq_hand_vars, vq_body_state,
    vq_hand_state, audio_enc_vars and prior_vars (the JAX Pipeline's
    `_body_arrays`); ae_vars: the variables of a JAX `AE` (optional).
    Returns {"face", "vq_body", "vq_hand", "audio_enc", "prior"[, "ae"]:
    state dicts, "vq_body_state", "vq_hand_state": VQState}."""
    out = {
        "face": convert_face(face_vars),
        "vq_body": convert_vqvae(body_vars["vq_body_vars"]),
        "vq_hand": convert_vqvae(body_vars["vq_hand_vars"]),
        "audio_enc": convert_audio_encoder(body_vars["audio_enc_vars"]),
        "prior": convert_pixelcnn(body_vars["prior_vars"]),
        "vq_body_state": _vq_state(body_vars["vq_body_state"]),
        "vq_hand_state": _vq_state(body_vars["vq_hand_state"]),
    }
    if ae_vars is not None:
        out["ae"] = convert_ae(ae_vars)
    return out


# ---------------------------------------------------------------------------
# reference .pth checkpoints
# ---------------------------------------------------------------------------

def strip_module_prefix(sd: dict) -> dict:
    """Drop DataParallel's `module.` from every key."""
    return {k.replace("module.", ""): v for k, v in sd.items()}


def _wrapper(ckpt: dict, key: str) -> dict:
    """The Trainer file {'generator': wrapper state, 'epoch', 'global_steps'}
    -> the wrapper's state (one that holds `key`; a bare wrapper state
    passes unchanged)."""
    return ckpt if key in ckpt else ckpt["generator"]


def _float(sd: dict) -> dict:
    return {k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()}


def reference_vqvae(sd: dict) -> tuple[dict, VQState]:
    """One reference VQVAE state dict (vqvae_1d.py:168-208) -> (the port's
    VQVAE state dict, VQState).  The EMA statistics default to zeros where
    the file has none; the reference does not save the update counter."""
    sd = strip_module_prefix(sd)
    emb = sd["vq_layer.embeddings"].float()
    state = VQState(
        emb,
        sd.get("vq_layer.ema_dw.hidden", torch.zeros_like(emb)).float(),
        sd.get("vq_layer.ema_cluster_size.hidden", torch.zeros(emb.shape[0])).float(),
        torch.zeros((), dtype=torch.int32))
    return _float({k: v for k, v in sd.items() if not k.startswith("vq_layer.")}), state


def reference_body_vq(ckpt: dict) -> dict:
    """Reference body-VQ checkpoint {'generator': {'g_body', 'g_hand', ..}}
    -> {"vq_body", "vq_hand": state dicts, "vq_body_state",
    "vq_hand_state": VQState}."""
    gen = _wrapper(ckpt, "g_body")
    (vb, sb), (vh, sh) = reference_vqvae(gen["g_body"]), reference_vqvae(gen["g_hand"])
    return {"vq_body": vb, "vq_hand": vh, "vq_body_state": sb, "vq_hand_state": sh}


def reference_pixelcnn(sd: dict) -> dict:
    """gated_pixelcnn_v2.GatedPixelCNN (:90-150) -> the port's GatedPixelCNN
    state dict: 1x1 Conv2d weights (out, in, 1, 1) become Linear (out, in),
    `output_conv.0/2` the head's out_hidden / out_logits, and layer 0's
    mask-A kernels lose their causally zeroed last row (vertical) and last
    column (horizontal)."""
    sd = strip_module_prefix(sd)
    out = {}
    for k, v in sd.items():
        k = k.replace("output_conv.0.", "out_hidden.").replace("output_conv.2.", "out_logits.")
        if k == "layers.0.vert_stack.weight":
            v = v[:, :, :-1, :]
        elif k == "layers.0.horiz_stack.weight":
            v = v[:, :, :, :-1]
        elif v.dim() == 4 and v.shape[2:] == (1, 1) and "stack" not in k:
            v = v[:, :, 0, 0]
        out[k] = v
    return _float(out)


def reference_body_pixel(ckpt: dict) -> dict:
    """Reference body-pixel checkpoint {'generator': {'generator',
    'audioencoder', ..}} -> {"prior", "audio_enc": state dicts}."""
    gen = _wrapper(ckpt, "audioencoder")
    return {"prior": reference_pixelcnn(gen["generator"]),
            "audio_enc": _float(strip_module_prefix(gen["audioencoder"]))}


#: the reference AE decoder's parameters that its forward never reads
#: (vqvae_1d.py:135-139)
_AE_DEAD = ("decoder.frame_enc.", "decoder.gru_sl.")


def reference_body_ae(ckpt: dict) -> dict:
    """The reference FGD feature extractor (nets/body_ae.py; the Trainer
    file {'generator': {'g': AE state dict, 'g_optim', ..}}, the wrapper
    state, or the bare state dict) -> the port's AE state dict, without
    the decoder's dead frame_enc / gru_sl parameters."""
    sd = ckpt.get("generator", ckpt)
    if "g" in sd:
        sd = sd["g"]
    sd = strip_module_prefix(sd)
    return _float({k: v for k, v in sd.items() if not k.startswith(_AE_DEAD)})


_FACE_REF = [(r"^decoder\.0\.", "heads.jaw_cnr."), (r"^decoder\.1\.", "heads.exp_cnr."),
             (r"^final_out\.0\.", "heads.jaw_out."), (r"^final_out\.1\.", "heads.exp_out."),
             (r"\.residual_layer\.0\.", ".residual_layer.")]


def _weight_norm(sd: dict, prefix: str) -> torch.Tensor:
    """A weight-normed conv weight (dim=2), either key layout, resolved."""
    if prefix + ".weight_g" in sd:
        g, v = sd[prefix + ".weight_g"], sd[prefix + ".weight_v"]
    else:
        g = sd[prefix + ".parametrizations.weight.original0"]
        v = sd[prefix + ".parametrizations.weight.original1"]
    g, v = g.double(), v.double()
    return (g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()).float()


#: the face state dict's SpecAugment vector (Wav2Vec2Encoder.masked_spec_embed)
MASKED_SPEC_EMBED = "audio_encoder.masked_spec_embed"


def masked_spec_embed_default(face_sd: dict) -> torch.Tensor:
    """The vector a face state dict without one gets: zeros, as
    talkshow_tpu/convert/wav2vec.py:63-65 gives a checkpoint that lacks it
    (inference never reads it)."""
    bias = face_sd["audio_encoder.feature_projection.projection.bias"]
    return torch.zeros_like(bias)


def reference_face(ckpt: dict) -> dict:
    """Reference face checkpoint ({'generator': {'generator': flat
    s2g_face.Generator state dict, 'generator_optim': ..}, 'epoch', ..}, or
    any level of that nesting) -> the port's FaceGenerator state dict."""
    sd = ckpt
    while isinstance(sd, dict) and "generator" in sd and not any("." in k for k in sd):
        sd = sd["generator"]
    sd = strip_module_prefix(sd)
    pos = "audio_encoder.encoder.pos_conv_embed.conv"
    out = {}
    for k, v in sd.items():
        if k.startswith(pos + ".") and k != pos + ".bias":
            continue
        out[_rename(k, _FACE_REF)] = v
    if MASKED_SPEC_EMBED not in out:
        out[MASKED_SPEC_EMBED] = masked_spec_embed_default(out)
    if pos + ".weight" in sd:
        out[pos + ".weight"] = sd[pos + ".weight"]
    else:
        out[pos + ".weight"] = _weight_norm(sd, pos)
    return _float(out)


def config_from_hf(hf) -> Wav2Vec2Config:
    """Hugging Face Wav2Vec2Config fields -> the port's Wav2Vec2Config (a
    copy of talkshow_tpu/convert/wav2vec.py:config_from_hf).  `hf` is a
    config object or a plain dict of its fields (as
    tests/fixtures/golden/meta.json holds them); a missing
    `layer_norm_eps` takes Hugging Face's default, 1e-5."""
    get = hf.get if isinstance(hf, dict) else (lambda k, d=None: getattr(hf, k, d))
    return Wav2Vec2Config(
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        conv_dim=tuple(get("conv_dim")),
        conv_kernel=tuple(get("conv_kernel")),
        conv_stride=tuple(get("conv_stride")),
        num_conv_pos_embeddings=get("num_conv_pos_embeddings"),
        num_conv_pos_embedding_groups=get("num_conv_pos_embedding_groups"),
        layer_norm_eps=get("layer_norm_eps", 1e-5),
    )

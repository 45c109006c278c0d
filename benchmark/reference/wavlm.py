"""Plain float32 reference of TalkSHOW's face generator with WavLM Large as
its speech encoder (`talkshow-wavlm-large`), in eager PyTorch.

Written from the equations of Chen et al., "WavLM: Large-Scale
Self-Supervised Pre-Training for Full Stack Speech Processing"
(arXiv:2110.13900) as Hugging Face's `WavLMModel` computes them
(`WavLMFeatureEncoder` with `feat_extract_norm="layer"`,
`WavLMEncoderStableLayerNorm`, `WavLMAttention`), and TalkSHOW's face
generator around it (`nets/spg/s2g_face.py`):

- extractor: each conv (no bias: WavLM Large's `conv_bias` is false) ->
  LayerNorm over its channels -> gelu;
- the extractor's 50 Hz features interpolated to the clip's 30 fps frames,
  then the feature projection (LayerNorm, Linear);
- x = x + posconv(x) (grouped conv, gelu, the even kernel's last frame
  cropped); no LayerNorm before the layers;
- each layer: x = x + Attn(LN1(x)), then x = x + FFN(LN2(x)); the stack
  ends with the encoder's LayerNorm;
- Attn: the scores q k^T / sqrt(hd) + g[h, i] bias[h, i, j], with
  bias[h, i, j] = E[bucket(j - i), h] from layer 0's table E (buckets,
  heads), shared by every layer, and each layer's gate
  g[h, i] = a (b c_h - 1) + 2, (a, b) = sigmoid of the two sums of 4 of
  the 8 outputs of a Linear(hd -> 8) on the head's slice of LN1's output;
- bucket(d): half the buckets a side, the upper half for d > 0; |d| below
  a quarter of the buckets maps to itself, beyond that to quarter +
  floor(ln(|d| / quarter) / ln(max_distance / quarter) * quarter),
  capped at half - 1;
- TalkSHOW's face heads on Linear(hidden -> 256) of the encoder's output.

Departures from those sources: no dropout, no SpecAugment, no attention
mask (a whole clip); the positional conv's weight norm is folded into one
weight (the port loads it so); `masked_spec_embed` is carried so that one
state dict loads here and into the program, and is never read.  It imports
nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import nets


def buckets(T: int, num_buckets: int, max_distance: int, device=None) -> torch.Tensor:
    """(T, T) int64: bucket(j - i) of query i and key j (see the module
    docstring), from the equation, float32 logarithm as Hugging Face."""
    half = num_buckets // 2
    quarter = half // 2
    pos = torch.arange(T, device=device)
    d = pos[None, :] - pos[:, None]
    a = d.abs()
    # quarter + the scaled log in float32, then truncated (Hugging Face's order)
    far = (quarter + torch.log(a.float().clamp_min(1) / quarter)
           / math.log(max_distance / quarter) * (half - quarter)).long().clamp(max=half - 1)
    return torch.where(d > 0, half, 0) + torch.where(a < quarter, a, far)


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, s, eps):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        self.layer_norm = nn.LayerNorm(cout, eps=eps)

    def forward(self, h):
        h = self.layer_norm(self.conv(h).transpose(1, 2)).transpose(1, 2)
        return F.gelu(h)


class FeatureExtractor(nn.Module):
    def __init__(self, w):
        super().__init__()
        dims = [1] + list(w["conv_dim"])
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, w["layer_norm_eps"])
            for i, (k, s) in enumerate(zip(w["conv_kernel"], w["conv_stride"])))

    def forward(self, x):
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, w, first: bool):
        super().__init__()
        hidden, heads = w["hidden_size"], w["num_heads"]
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(hidden // heads, 8)
        if first:
            self.rel_attn_embed = nn.Embedding(w["num_buckets"], heads)

    def gate(self, x):
        """(B, T, C) normalised input -> (B, heads, T, 1)."""
        B, T, C = x.shape
        xh = x.reshape(B, T, self.heads, C // self.heads).transpose(1, 2)   # (B, h, T, hd)
        proj = self.gru_rel_pos_linear(xh).reshape(B, self.heads, T, 2, 4).sum(-1)
        a, b = torch.sigmoid(proj).chunk(2, dim=-1)
        return a * (b * self.gru_rel_pos_const - 1.0) + 2.0

    def forward(self, x, bias):
        """x (B, T, C) = LN1's output; bias (heads, T, T) shared."""
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        s = q @ k.transpose(-1, -2) + self.gate(x) * bias[None]
        w = torch.softmax(s, dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, C))


class EncoderLayer(nn.Module):
    def __init__(self, w, first: bool):
        super().__init__()
        eps = w["layer_norm_eps"]
        self.attention = Attention(w, first)
        self.layer_norm = nn.LayerNorm(w["hidden_size"], eps=eps)
        self.feed_forward = nets.FeedForward(w["hidden_size"], w["intermediate_size"])
        self.final_layer_norm = nn.LayerNorm(w["hidden_size"], eps=eps)

    def forward(self, x, bias):
        x = x + self.attention(self.layer_norm(x), bias)
        return x + self.feed_forward(self.final_layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.pos_conv_embed = nets.PositionalConvEmbedding(w)
        self.layer_norm = nn.LayerNorm(w["hidden_size"], eps=w["layer_norm_eps"])
        self.layers = nn.ModuleList(EncoderLayer(w, i == 0) for i in range(w["num_layers"]))


class WavLM(nn.Module):
    """waveform (B, N) at 16 kHz -> (B, frames, hidden), the 50 Hz features
    interpolated to `frames` before the projection (TalkSHOW's mid-stack
    resampling)."""

    def __init__(self, w):
        super().__init__()
        self.w = w
        self.feature_extractor = FeatureExtractor(w)
        self.feature_projection = nets.FeatureProjection(w)
        self.encoder = Encoder(w)
        self.masked_spec_embed = nn.Parameter(torch.zeros(w["hidden_size"]))

    def forward(self, wav, frames):
        x = self.feature_projection(nets.linear_interpolate(self.feature_extractor(wav), frames))
        x = x + self.encoder.pos_conv_embed(x)
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        bias = table[buckets(x.shape[1], self.w["num_buckets"], self.w["max_bucket_distance"],
                             x.device)].permute(2, 0, 1)
        for layer in self.encoder.layers:
            x = layer(x, bias)
        return self.encoder.layer_norm(x)


class FaceGenerator(nn.Module):
    """waveform (B, N) + speaker one-hot (B, classes) -> (B, frames, jaw + exp)."""

    def __init__(self, w, face):
        super().__init__()
        f = face["feature_dim"]
        self.audio_encoder = WavLM(w)
        self.audio_feature_map = nn.Linear(w["hidden_size"], f)
        self.audio_middle = nets.FaceAudioMiddle(f, f, face["num_classes"])
        self.heads = nets.FaceDecoderHeads(f, face["jaw_dim"], face["exp_dim"])

    def forward(self, wav, id_onehot, frames):
        h = self.audio_encoder(wav, frames)
        return self.heads(self.audio_middle(self.audio_feature_map(h), id_onehot))


def build(cfg: dict) -> dict:
    """{"face": module} at the configuration's widths (on the current
    default device; under `torch.device("meta")` to only count)."""
    return {"face": FaceGenerator(cfg["wav2vec"], cfg["face"])}


class Reference:
    """The WavLM face generator on `weights` ({"face": state dict}), eval
    mode, float32 with TF32 off.  `quantize` (a function of a weight tensor)
    puts a lower precision in place: the control."""

    def __init__(self, cfg: dict, weights: dict, device, quantize=None):
        with torch.device("meta"):
            m = build(cfg)["face"]
        self.cfg, self.device = cfg, torch.device(device)
        m.to_empty(device=self.device)
        sd = weights["face"]
        if quantize is not None:
            sd = {k: quantize(v) if v.dim() >= 2 else v for k, v in sd.items()}
        m.load_state_dict(sd)
        self.m = m.eval()

    @torch.no_grad()
    def face(self, wav16k: torch.Tensor) -> torch.Tensor:
        """(N,) 16 kHz -> (N * 30 // 16000, 103), a zero speaker one-hot (the
        path of `generate_face`)."""
        frames = int(wav16k.shape[0] * 30 // 16000)
        onehot = torch.zeros(1, self.cfg["face"]["num_classes"], device=self.device)
        return self.m(wav16k[None], onehot, frames)[0]

"""Plain float32 reference of the TalkSHOW models, in eager PyTorch.

A frozen copy of the plain mathematics of the models the benchmark runs:
the wav2vec 2.0 face generator, the 1-D conv VQ-VAEs, the MFCC audio
encoder and the audio-conditioned Gated PixelCNN prior (its teacher-forced
full-grid forward).  Parameter and buffer names follow the reference
TalkSHOW / Hugging Face modules, so one state dict loads into this file's
modules and into the program's.  It imports nothing of the program and has
no kernels, no packed tables, no caches and no compute dtype: everything
is float32, inference mode (BatchNorm from its running statistics), and a
batch is whole (no length masks).

Sources of the equations: TalkSHOW `nets/spg/vqvae_1d.py`,
`nets/spg/vqvae_modules.py`, `nets/spg/gated_pixelcnn_v2.py`,
`nets/layers.py`, `nets/spg/s2g_face.py`, and Hugging Face's
`Wav2Vec2Model` (post-norm, `do_stable_layer_norm=False`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# conv blocks (vqvae_modules.py, nets/layers.py), channels-first inside
# ---------------------------------------------------------------------------

def _act(x, leaky):
    return F.leaky_relu(x, 0.2) if leaky else F.relu(x)


class ConvNormRelu(nn.Module):
    """conv - BatchNorm - (+ residual) - (leaky) ReLU; sample 'none' k3 s1
    p1, 'down' k4 s2 p1, 'up' ConvTranspose1d k4 s2 p1."""

    def __init__(self, cin, cout, leaky=False, sample="none", residual=False):
        super().__init__()
        k, s, p = (3, 1, 1) if sample == "none" else (4, 2, 1)
        conv = nn.ConvTranspose1d if sample == "up" else nn.Conv1d
        self.leaky, self.residual = leaky, residual
        self.conv = conv(cin, cout, k, s, p)
        self.norm = nn.BatchNorm1d(cout, eps=1e-5)
        self.residual_layer = None
        if residual and (sample in ("up", "down") or cin != cout):
            self.residual_layer = conv(cin, cout, k, s, p)

    def forward(self, x):
        out = self.norm(self.conv(x))
        if self.residual:
            out = out + (x if self.residual_layer is None else self.residual_layer(x))
        return _act(out, self.leaky)


class ResCNRStack(nn.Module):
    def __init__(self, ch, layers, leaky=False):
        super().__init__()
        self._layers = nn.ModuleList(ConvNormRelu(ch, ch, leaky=leaky) for _ in range(layers))
        self.conv = nn.Conv1d(ch, ch, 3, 1, 1)
        self.norm = nn.BatchNorm1d(ch, eps=1e-5)

    def forward(self, x):
        h = x
        for layer in self._layers:
            h = layer(h)
        return F.relu(self.norm(self.conv(h)) + x)


class CNR1d(nn.Module):
    """conv k3 s1 p1 - LayerNorm over channels - (+ residual) - ReLU, on
    channels-last (B, T, C)."""

    def __init__(self, cin, cout, residual=False):
        super().__init__()
        self.residual = residual
        self.conv = nn.Conv1d(cin, cout, 3, 1, 1)
        self.norm = nn.LayerNorm(cout, eps=1e-5)
        self.residual_layer = None
        if residual and cin != cout:
            self.residual_layer = nn.Conv1d(cin, cout, 3, 1, 1)

    def forward(self, x):
        xt = x.transpose(1, 2)
        out = self.norm(self.conv(xt).transpose(1, 2))
        if self.residual:
            out = out + (x if self.residual_layer is None
                         else self.residual_layer(xt).transpose(1, 2))
        return F.relu(out)


class SeqTranslator1D(nn.Module):
    def __init__(self, cin, cout, min_layers_num=1, residual=True):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            CNR1d(cin if i == 0 else cout, cout, residual=residual)
            for i in range(max(1, min_layers_num)))

    def forward(self, x):
        for layer in self.conv_layers:
            x = layer(x)
        return x


def linear_interpolate(x, out_len):
    """F.interpolate(mode='linear', align_corners=False) on axis 1 of (B, T, C)."""
    y = F.interpolate(x.transpose(1, 2), size=out_len, mode="linear", align_corners=False)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# VQ-VAE and the MFCC audio encoder (vqvae_1d.py)
# ---------------------------------------------------------------------------

class VQEncoder(nn.Module):
    def __init__(self, cin, emb=64, nh=1024, r=2):
        super().__init__()
        self.project = ConvNormRelu(cin, nh // 4, leaky=True)
        self._enc_1 = ResCNRStack(nh // 4, r, leaky=True)
        self._down_1 = ConvNormRelu(nh // 4, nh // 2, leaky=True, residual=True, sample="down")
        self._enc_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._down_2 = ConvNormRelu(nh // 2, nh, leaky=True, residual=True, sample="down")
        self._enc_3 = ResCNRStack(nh, r, leaky=True)
        self.pre_vq_conv = nn.Conv1d(nh, emb, 1)

    def forward(self, x):
        h = x.transpose(1, 2)
        for b in (self.project, self._enc_1, self._down_1, self._enc_2, self._down_2,
                  self._enc_3):
            h = b(h)
        return self.pre_vq_conv(h).transpose(1, 2)


class VQDecoder(nn.Module):
    def __init__(self, cout, emb=64, nh=1024, r=2):
        super().__init__()
        self.aft_vq_conv = nn.Conv1d(emb, nh, 1)
        self._dec_1 = ResCNRStack(nh, r, leaky=True)
        self._up_2 = ConvNormRelu(nh, nh // 2, leaky=True, residual=True, sample="up")
        self._dec_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._up_3 = ConvNormRelu(nh // 2, nh // 4, leaky=True, residual=True, sample="up")
        self._dec_3 = ResCNRStack(nh // 4, r, leaky=True)
        self.project = nn.Conv1d(nh // 4, cout, 1)

    def forward(self, e):
        h = self.aft_vq_conv(e.transpose(1, 2))
        for b in (self._dec_1, self._up_2, self._dec_2, self._up_3, self._dec_3):
            h = b(h)
        return self.project(h).transpose(1, 2)


class VQVAE(nn.Module):
    """Decoder first, encoder second (the reference's registration order)."""

    def __init__(self, channels, emb=64, nh=1024, r=2):
        super().__init__()
        self.decoder = VQDecoder(channels, emb, nh, r)
        self.encoder = VQEncoder(channels, emb, nh, r)

    def decode_tokens(self, codebook, tokens):
        """(B, W) int tokens -> (B, 4 W, channels) through the codebook (K, D)."""
        return self.decoder(codebook[tokens])


class AudioEncoder(nn.Module):
    def __init__(self, cin=64, nh=256, r=2):
        super().__init__()
        self.project = ConvNormRelu(cin, nh // 4, leaky=True)
        self._enc_1 = ResCNRStack(nh // 4, r, leaky=True)
        self._down_1 = ConvNormRelu(nh // 4, nh // 2, leaky=True, residual=True, sample="down")
        self._enc_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._down_2 = ConvNormRelu(nh // 2, nh, leaky=True, residual=True, sample="down")
        self._enc_3 = ResCNRStack(nh, r, leaky=True)

    def forward(self, x):
        h = x.transpose(1, 2)
        for b in (self.project, self._enc_1, self._down_1, self._enc_2, self._down_2,
                  self._enc_3):
            h = b(h)
        return h.transpose(1, 2)


# ---------------------------------------------------------------------------
# Gated PixelCNN prior (gated_pixelcnn_v2.py), teacher-forced
# ---------------------------------------------------------------------------

def _gate(x):
    a, b = x.chunk(2, dim=-1)
    return torch.tanh(a) * torch.sigmoid(b)


class GatedMaskedLayer(nn.Module):
    """Mask A (layer 0): 3 vertical kernel rows above the token, one
    strictly-left horizontal tap.  Mask B: 4 rows down to the token's own,
    taps left and self."""

    def __init__(self, dim, mask_type, n_classes, residual):
        super().__init__()
        kernel = 7 if mask_type == "A" else 3
        kh = kernel // 2 + 1
        self.pad_top = kernel // 2
        self.vrows = kh - 1 if mask_type == "A" else kh
        self.hcols = 1 if mask_type == "A" else 2
        self.residual = residual
        self.class_cond_embedding = nn.Embedding(n_classes, 2 * dim)
        self.vert_stack = nn.Conv2d(dim, 2 * dim, (self.vrows, 3))
        self.vert_to_horiz = nn.Linear(2 * dim, 2 * dim)
        self.horiz_stack = nn.Conv2d(dim, 2 * dim, (1, self.hcols))
        self.horiz_resid = nn.Linear(dim, dim)

    def forward(self, x_v, x_h, label):
        """x_v, x_h (B, H, W, dim) channels-last."""
        H, W = x_v.shape[1], x_v.shape[2]
        cls = self.class_cond_embedding(label)[:, None, None, :]
        xp = F.pad(x_v.permute(0, 3, 1, 2), (1, 1, self.pad_top, 0))
        h_vert = self.vert_stack(xp).permute(0, 2, 3, 1)[:, :H]
        out_v = _gate(h_vert + cls)
        hp = F.pad(x_h.permute(0, 3, 1, 2), (1, 0))
        h_horiz = self.horiz_stack(hp).permute(0, 2, 3, 1)[:, :, :W]
        out = _gate(self.vert_to_horiz(h_vert) + h_horiz + cls)
        out_h = self.horiz_resid(out)
        return out_v, (out_h + x_h if self.residual else out_h)


class GatedPixelCNN(nn.Module):
    """tokens (B, H, 2) + speaker (B,) + audio (B, H, A) -> logits (B, H, 2, K)."""

    def __init__(self, input_dim=2048, dim=256, n_layers=15, n_classes=4,
                 audio_channels=256, hidden=512):
        super().__init__()
        self.embedding = nn.Embedding(input_dim, dim)
        self.embedding_aud = nn.Linear(audio_channels, dim)
        self.fusion_v = nn.Linear(2 * dim, dim)
        self.fusion_h = nn.Linear(2 * dim, dim)
        self.layers = nn.ModuleList(GatedMaskedLayer(dim, "A" if i == 0 else "B", n_classes,
                                                     residual=i > 0) for i in range(n_layers))
        self.out_hidden = nn.Linear(dim, hidden)
        self.out_logits = nn.Linear(hidden, input_dim)

    def forward(self, tokens, label, audio, aud_keep=None):
        """aud_keep (B, H) bool: training's dropout of the audio embedding
        (rate 0.1), a row kept scaled by 1 / 0.9 or zeroed."""
        x = self.embedding(tokens)
        x_v = x_h = x
        aud = self.embedding_aud(audio)
        if aud_keep is not None:
            aud = aud * (aud_keep.float() / 0.9)[..., None]
        aud = aud[:, :, None, :].expand(x.shape[:3] + (x.shape[-1],))
        for i, layer in enumerate(self.layers):
            if i == 1:
                x_v = self.fusion_v(torch.cat([x_v, aud], dim=-1))
                x_h = self.fusion_h(torch.cat([x_h, aud], dim=-1))
            x_v, x_h = layer(x_v, x_h, label)
        return self.out_logits(F.relu(self.out_hidden(x_h)))


# ---------------------------------------------------------------------------
# wav2vec 2.0 (Hugging Face Wav2Vec2Model, base) and the face generator
# ---------------------------------------------------------------------------

class ChannelGroupNorm(nn.Module):
    """GroupNorm with one group per channel (nn.GroupNorm's names)."""

    def __init__(self, ch, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x, x.shape[1], self.weight, self.bias, self.eps)


class _ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, s, eps):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        self.layer_norm = ChannelGroupNorm(cout, eps) if eps is not None else None


class FeatureExtractor(nn.Module):
    def __init__(self, w):
        super().__init__()
        dims = [1] + list(w["conv_dim"])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, w["layer_norm_eps"] if i == 0 else None)
            for i, (k, s) in enumerate(zip(w["conv_kernel"], w["conv_stride"])))

    def forward(self, x):
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer.conv(h)
            if layer.layer_norm is not None:
                h = layer.layer_norm(h)
            h = F.gelu(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.layer_norm = nn.LayerNorm(w["conv_dim"][-1], eps=w["layer_norm_eps"])
        self.projection = nn.Linear(w["conv_dim"][-1], w["hidden_size"])

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, w):
        super().__init__()
        k = w["num_conv_pos_embeddings"]
        self.crop = k % 2 == 0
        self.conv = nn.Conv1d(w["hidden_size"], w["hidden_size"], k, padding=k // 2,
                              groups=w["num_conv_pos_embedding_groups"])

    def forward(self, x):
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(h[:, :-1] if self.crop else h)


class Attention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, C))


class FeedForward(nn.Module):
    def __init__(self, hidden, inter):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, inter)
        self.output_dense = nn.Linear(inter, hidden)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, w):
        super().__init__()
        eps = w["layer_norm_eps"]
        self.attention = Attention(w["hidden_size"], w["num_heads"])
        self.layer_norm = nn.LayerNorm(w["hidden_size"], eps=eps)
        self.feed_forward = FeedForward(w["hidden_size"], w["intermediate_size"])
        self.final_layer_norm = nn.LayerNorm(w["hidden_size"], eps=eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(w)
        self.layer_norm = nn.LayerNorm(w["hidden_size"], eps=w["layer_norm_eps"])
        self.layers = nn.ModuleList(EncoderLayer(w) for _ in range(w["num_layers"]))


class Wav2Vec2(nn.Module):
    """waveform (B, N) at 16 kHz -> (B, frames, hidden), the 50 Hz features
    interpolated to `frames` (30 fps) before the projection (TalkSHOW's
    mid-stack resampling)."""

    def __init__(self, w):
        super().__init__()
        self.feature_extractor = FeatureExtractor(w)
        self.feature_projection = FeatureProjection(w)
        self.encoder = Encoder(w)
        self.masked_spec_embed = nn.Parameter(torch.zeros(w["hidden_size"]))

    def forward(self, wav, frames):
        x = self.feature_projection(linear_interpolate(self.feature_extractor(wav), frames))
        x = self.encoder.layer_norm(x + self.encoder.pos_conv_embed(x))
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class FaceAudioMiddle(nn.Module):
    def __init__(self, in_dim, out_dim, num_classes):
        super().__init__()
        self.id_mlp = nn.Conv1d(num_classes, 64, 1)
        self.first_net = SeqTranslator1D(in_dim + 64, out_dim, min_layers_num=3, residual=True)

    def forward(self, x, id_onehot):
        idf = id_onehot[:, :, None].expand(-1, -1, x.shape[1])
        idf = self.id_mlp(idf).transpose(1, 2)
        return self.first_net(torch.cat([x, idf], dim=-1))


class FaceDecoderHeads(nn.Module):
    def __init__(self, in_dim, jaw_dim, exp_dim, hidden=256):
        super().__init__()
        self.jaw_cnr = nn.ModuleList(CNR1d(in_dim if i == 0 else 64, 64) for i in range(3))
        self.jaw_out = nn.Conv1d(64, jaw_dim, 1)
        self.exp_cnr = nn.ModuleList(CNR1d(in_dim if i == 0 else hidden, hidden)
                                     for i in range(3))
        self.exp_out = nn.Conv1d(hidden, exp_dim, 1)

    def forward(self, f):
        h, g = f, f
        for layer in self.jaw_cnr:
            h = layer(h)
        for layer in self.exp_cnr:
            g = layer(g)
        return torch.cat([self.jaw_out(h.transpose(1, 2)).transpose(1, 2),
                          self.exp_out(g.transpose(1, 2)).transpose(1, 2)], dim=-1)


class FaceGenerator(nn.Module):
    """waveform (B, N) + speaker one-hot (B, classes) -> (B, frames, jaw + exp)."""

    def __init__(self, w, face):
        super().__init__()
        f = face["feature_dim"]
        self.audio_encoder = Wav2Vec2(w)
        self.audio_feature_map = nn.Linear(w["hidden_size"], f)
        self.audio_middle = FaceAudioMiddle(f, f, face["num_classes"])
        self.heads = FaceDecoderHeads(f, face["jaw_dim"], face["exp_dim"])

    def forward(self, wav, id_onehot, frames):
        h = self.audio_encoder(wav, frames)
        return self.heads(self.audio_middle(self.audio_feature_map(h), id_onehot))

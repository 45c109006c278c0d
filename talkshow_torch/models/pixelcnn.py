"""Audio- and speaker-conditioned Gated PixelCNN prior over VQ token grids
(port of talkshow_tpu/models/pixelcnn.py:36-368).

The token grid is (H = T/4, W = 2 = [body, hand]).  `GatedPixelCNN.forward`
is the teacher-forced full-grid forward; given `aud_keep` it is the train
forward with the per-row dropout of the audio embedding (rate 0.1, JAX
:166,202-208), which `draw_aud_keep` draws from a generator.
`sample_tokens` is the cached O(H) row-step sampler: the vertical stack
is row-causal, so each layer's new row needs a one- or two-row cache, and
the horizontal stack is re-evaluated once per column.  It is the plain PyTorch version of the
CUDA decode kernel (`talkshow_torch/kernels/ar_decode.py`), which the
wrapper uses for CPU tensors and which chip_smoke.py holds the kernel
against on the card.

Masking is structural, as in the JAX package: mask-A layers (layer 0) have
3 vertical kernel rows and a single strictly-left horizontal tap; the
causal shift comes from explicit asymmetric padding.  1x1 convolutions are
`nn.Linear` on channels-last tensors.

`dtype` (None = f32; bf16 for `--bf16` training) is flax's compute dtype
of the teacher-forced forward (talkshow_tpu/models/pixelcnn.py:55-77,
149-183): the embeddings, the audio embedding, the fusions, every layer's
convs and 1x1s, the class embeddings and the head compute in it, with f32
parameters; the audio dropout's f32 scale promotes its product to f32 as
flax's does, and the caller takes the cross-entropy in f32.  The sampler
and K1 read the f32 parameters as always.

`bh_model=False` is the vertical-only prior (JAX :57-111,209-213): no
horizontal stack, a one-column vertical kernel, and the head reads the
vertical stream.  It trains (the teacher-forced forward), but it cannot be
sampled: JAX's incremental sampler calls `fusion_h`, which this prior does
not have (talkshow_tpu/models/pixelcnn.py:262-265, flax's
ScopeParamNotFoundError), and its row step carries the bh_model=True data
flow (:226-252).  The port adds no sampler JAX lacks, so `sample_tokens`,
`generate_conv_poses` and K1 refuse it (`check_sampleable`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.kernels import counts
from talkshow_torch.models.layers import conv, dense, embed


def gate(x: torch.Tensor) -> torch.Tensor:
    """Split the last axis in half -> tanh(a) * sigmoid(b)."""
    a, b = x.chunk(2, dim=-1)
    return torch.tanh(a) * torch.sigmoid(b)


class GatedMaskedLayer(nn.Module):
    """One gated masked layer (reference gated_pixelcnn_v2.py:25-87), NHWC.
    bh_model=False: the vertical-only layer (one-column vertical kernel, no
    horizontal stack)."""

    def __init__(self, dim: int, mask_type: str, n_classes: int,
                 residual: bool, bh_model: bool = True):
        super().__init__()
        self.dim = dim
        self.kernel = 7 if mask_type == "A" else 3
        kh = self.kernel // 2 + 1
        self.vrows = kh - 1 if mask_type == "A" else kh
        self.hcols = 1 if mask_type == "A" else 2
        self.residual = residual
        self.bh_model = bh_model
        self.class_cond_embedding = nn.Embedding(n_classes, 2 * dim)
        self.vert_stack = nn.Conv2d(dim, 2 * dim, (self.vrows, 3 if bh_model else 1))
        if bh_model:
            self.vert_to_horiz = nn.Linear(2 * dim, 2 * dim)
            self.horiz_stack = nn.Conv2d(dim, 2 * dim, (1, self.hcols))
        self.horiz_resid = nn.Linear(dim, dim)

    def vert_conv(self, x: torch.Tensor, pad_top: int, dtype=None) -> torch.Tensor:
        """(B, R, W, dim) -> (B, R + pad_top - vrows + 1, W, 2dim) pre-gate."""
        wpad = 1 if self.bh_model else 0
        xp = F.pad(x.permute(0, 3, 1, 2), (wpad, wpad, pad_top, 0))
        return conv(self.vert_stack, xp, dtype).permute(0, 2, 3, 1)

    def horiz_conv(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """(B, R, W, dim) -> (B, R, W, 2dim): column c sees x[c-1] (and
        x[c] for mask B)."""
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 0))
        return conv(self.horiz_stack, xp, dtype).permute(0, 2, 3, 1)[:, :, : x.shape[2]]

    def horiz(self, h_vert, x_h, cls, dtype=None):
        """Horizontal half given pre-gate vertical features (any leading
        shape with W on axis -2); returns out_h."""
        out = gate(dense(self.vert_to_horiz, h_vert, dtype) + self.horiz_conv(x_h, dtype) + cls)
        out_h = dense(self.horiz_resid, out, dtype)
        return out_h + x_h if self.residual else out_h

    def forward(self, x_v, x_h, label, dtype=None):
        cls = embed(self.class_cond_embedding, label, dtype)[:, None, None, :]
        h_vert = self.vert_conv(x_v, self.kernel // 2, dtype)[:, : x_v.shape[1]]
        if self.bh_model:
            return gate(h_vert + cls), self.horiz(h_vert, x_h, cls, dtype)
        out = dense(self.horiz_resid, gate(h_vert + cls), dtype)
        if self.residual:
            out = out + x_v
        return out, out


#: train-mode dropout rate of the audio embedding (talkshow_tpu/models/pixelcnn.py:166)
AUD_DROPOUT = 0.1


def draw_aud_keep(batch: int, rows: int, generator: torch.Generator,
                  device) -> torch.Tensor:
    """(batch, rows) bool keep mask of the audio dropout, each True with
    probability 1 - AUD_DROPOUT, drawn on the generator's device."""
    u = torch.rand((batch, rows), generator=generator, device=generator.device)
    return (u < 1.0 - AUD_DROPOUT).to(device)


class GatedPixelCNN(nn.Module):
    """tokens (B, H, W) int -> logits (B, H, W, input_dim)."""

    def __init__(self, input_dim: int = 2048, dim: int = 256,
                 n_layers: int = 15, n_classes: int = 4,
                 audio_channels: int = 256, hidden: int = 512,
                 bh_model: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.input_dim, self.dim, self.n_layers = input_dim, dim, n_layers
        self.bh_model, self.dtype = bh_model, dtype
        self.embedding = nn.Embedding(input_dim, dim)
        self.embedding_aud = nn.Linear(audio_channels, dim)
        self.fusion_v = nn.Linear(2 * dim, dim)
        if bh_model:
            self.fusion_h = nn.Linear(2 * dim, dim)
        self.layers = nn.ModuleList(
            GatedMaskedLayer(dim, "A" if i == 0 else "B", n_classes,
                             residual=i > 0, bh_model=bh_model) for i in range(n_layers))
        self.out_hidden = nn.Linear(dim, hidden)
        self.out_logits = nn.Linear(hidden, input_dim)

    def head(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        return dense(self.out_logits, F.relu(dense(self.out_hidden, x, dtype)), dtype)

    def forward(self, tokens, label, audio, aud_keep=None):
        """Teacher-forced forward. audio: (B, H, audio_channels).

        aud_keep (B, H) bool selects the train forward: the audio embedding
        of row h of example b is kept, scaled by 1 / (1 - AUD_DROPOUT), or
        zeroed, the same value over both columns and every channel, as
        JAX multiplies it by `aud_dropout(ones)`."""
        dt = self.dtype
        x = embed(self.embedding, tokens, dt)                           # (B, H, W, dim)
        x_v, x_h = x, x
        aud_e = dense(self.embedding_aud, audio, dt)
        if aud_keep is not None:
            aud_e = aud_e * (aud_keep.float() / (1.0 - AUD_DROPOUT))[..., None]
        aud_e = aud_e[:, :, None, :].expand(x.shape[:3] + aud_e.shape[-1:])
        for i, layer in enumerate(self.layers):
            if i == 1:
                x_v = dense(self.fusion_v, torch.cat([x_v.to(aud_e.dtype), aud_e], dim=-1), dt)
                if self.bh_model:
                    x_h = dense(self.fusion_h, torch.cat([x_h.to(aud_e.dtype), aud_e], dim=-1),
                                dt)
            x_v, x_h = layer(x_v, x_h, label, dt)
        return self.head(x_h if self.bh_model else x_v, dt)

    # -- incremental decode building blocks --------------------------------
    def row_step(self, emb_hist, v_prev, cls, aud_e):
        """Advance the vertical stack one row.

        emb_hist: (B, 3, W, dim) embeddings of rows i-3..i-1;
        v_prev: (n_layers-1, B, W, dim) inputs x_v of layers 1.. at row i-1;
        cls: per-layer (B, 1, 2dim); aud_e: (B, W, dim).
        Returns (pre-gate vertical rows per layer, new v_prev)."""
        h_rows, new_prev = [], []
        hv = self.layers[0].vert_conv(emb_hist, 0)[:, 0]
        h_rows.append(hv)
        x_v = gate(hv + cls[0])
        for l in range(1, self.n_layers):
            if l == 1:
                x_v = self.fusion_v(torch.cat([x_v, aud_e], dim=-1))
            new_prev.append(x_v)
            window = torch.stack([v_prev[l - 1], x_v], dim=1)
            hv = self.layers[l].vert_conv(window, 0)[:, 0]
            h_rows.append(hv)
            x_v = gate(hv + cls[l])
        return h_rows, torch.stack(new_prev)

    def horiz_logits_row(self, h_rows, row_emb, cls, aud_e):
        """Horizontal pass of one row -> logits (B, W, input_dim)."""
        x_h = row_emb
        for l, layer in enumerate(self.layers):
            if l == 1:
                x_h = self.fusion_h(torch.cat([x_h, aud_e], dim=-1))
            x_h = layer.horiz(h_rows[l][:, None], x_h[:, None], cls[l][:, None])[:, 0]
        return self.head(x_h)


def check_sampleable(model: GatedPixelCNN) -> None:
    """Raise ValueError for a prior that no sampler of the JAX package can
    run: the bh_model=False prior (see the module docstring)."""
    if not model.bh_model:
        raise ValueError(
            "the bh_model=false prior cannot be sampled: JAX's incremental sampler "
            "(talkshow_tpu/models/pixelcnn.py:sample_tokens) calls fusion_h, which this "
            "prior has no parameters for (ScopeParamNotFoundError), and its fused kernel "
            "refuses it (pixelcnn_pallas.supports_fused); train it, do not sample it")


def gumbel_noise(shape, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """-log(-log(U)), U uniform on (tiny, 1), drawn on the generator's
    device and moved to `device`."""
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=gdev)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


@torch.no_grad()
def sample_tokens(model: GatedPixelCNN, label: torch.Tensor,
                  audio: torch.Tensor, *, noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None,
                  prefix_tokens: torch.Tensor | None = None,
                  prefix_len: int = 0, return_logits: bool = False):
    """Cached AR sampler (plain PyTorch version of the decode kernel).

    audio: (B, H, audio_channels); label: (B,) int.  Each token is
    argmax(logits + g) with g gumbel noise: `noise` (H, 2, B, K) is used as
    given (tests hand in the JAX sampler's own block, so tokens reproduce
    it bit for bit), otherwise it is drawn from `generator`.  Rows below
    `prefix_len` are teacher-forced to `prefix_tokens` (B, H, 2).
    Returns tokens (B, H, 2) int64 [, logits (B, H, 2, K)].  A
    bh_model=False prior raises ValueError (`check_sampleable`).
    """
    check_sampleable(model)
    counts["sample_tokens_plain"] += 1
    B, H, _ = audio.shape
    W, dim, L, K = 2, model.dim, model.n_layers, model.input_dim
    dev = audio.device
    if noise is None:
        noise = gumbel_noise((H, W, B, K), generator, dev)
    if prefix_tokens is None:
        prefix_tokens = torch.zeros((B, H, W), dtype=torch.long, device=dev)
    cls = [layer.class_cond_embedding(label)[:, None, :] for layer in model.layers]
    aud_e = model.embedding_aud(audio)                        # (B, H, dim)
    emb_hist = torch.zeros((B, 3, W, dim), device=dev)
    v_prev = torch.zeros((L - 1, B, W, dim), device=dev)
    rows, logit_rows = [], []
    for i in range(H):
        a = aud_e[:, i, None, :].expand(B, W, dim)
        h_rows, v_prev = model.row_step(emb_hist, v_prev, cls, a)
        teacher = i < prefix_len
        row_emb = torch.zeros((B, W, dim), device=dev)
        logits0 = model.horiz_logits_row(h_rows, row_emb, cls, a)[:, 0]
        t0 = (prefix_tokens[:, i, 0] if teacher
              else torch.argmax(logits0 + noise[i, 0], dim=-1))
        row_emb = torch.stack([model.embedding(t0), row_emb[:, 1]], dim=1)
        logits1 = model.horiz_logits_row(h_rows, row_emb, cls, a)[:, 1]
        t1 = (prefix_tokens[:, i, 1] if teacher
              else torch.argmax(logits1 + noise[i, 1], dim=-1))
        row = torch.stack([t0, t1], dim=-1).long()            # (B, W)
        rows.append(row)
        if return_logits:
            logit_rows.append(torch.stack([logits0, logits1], dim=1))
        emb_hist = torch.cat([emb_hist[:, 1:], model.embedding(row)[:, None]], dim=1)
    tokens = torch.stack(rows, dim=1)
    if return_logits:
        return tokens, torch.stack(logit_rows, dim=1)
    return tokens

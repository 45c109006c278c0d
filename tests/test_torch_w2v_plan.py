"""K2's bf16 storage plan, written out in PyTorch and held to the plain stack.

With bf16 tables every product of the encoder-layer kernel (K2,
csrc/wav2vec_layers.cu) rounds its A operand to bf16, so the kernel stores
whatever feeds a product in bf16: qkv with the q columns already multiplied
by 1/sqrt(hd) (the plain version rounds q * scale), the attention output
ctx, the FFN hidden layer hb, and a bf16 copy of each LayerNorm output
beside the f32 one that the residual reads (layer 0's input gets one cast).
`planned_layers` below stores exactly there and nowhere else.  Each store
sits where `encoder_layers_plain` rounds anyway, so the result is bit-equal:
a store moved to another point (as rounding q before the scale) breaks the
equality on the CPU, where the card's 1e-2 tolerance would hide it.  Split-K
sums each product's k chunks in a fixed order, as the kernel's clusters do;
that changes only the f32 summation order, so it stays within the card
tests' bf16 tolerance (1e-2 of max|out|).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from talkshow_torch.kernels import wav2vec_layers as k2
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder

HEADS = {16: 4, 48: 2, 64: 2}   # head dim: heads (hidden = their product)


def _case(hd, seed=0):
    H = hd * HEADS[hd]
    cfg = Wav2Vec2Config(hidden_size=H, num_layers=2, num_heads=HEADS[hd], intermediate_size=2 * H)
    gen = torch.Generator().manual_seed(seed)
    enc = init_weights_(Wav2Vec2Encoder(cfg), gen)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((2, 37, H)), dtype=torch.float32)
    vf = torch.tensor([37, 20], dtype=torch.int32)
    return k2.pack_encoder_tables(enc.eval(), torch.bfloat16), x, vf


@torch.no_grad()
def planned_layers(tables, x, valid_frames, splits=1, scale_first=True):
    """The stack as K2 stores it (bf16 tables).  splits > 1 sums each
    product over that many chunks of whole 64-wide k tiles, in order;
    scale_first=False rounds q before the scale (a wrong plan)."""
    bf = torch.bfloat16
    B, T, H = x.shape
    nh = tables["heads"]
    hd = H // nh
    key_ok = (torch.arange(T)[None] < valid_frames[:, None])[:, None, None, :]

    def dot(ab, w):                       # ab: a stored bf16 operand
        a, wf = ab.float(), w.float()
        if splits == 1:
            return a @ wf.T
        k_tiles = -(-a.shape[-1] // 64)
        step = -(-k_tiles // splits) * 64
        out = None
        for k0 in range(0, a.shape[-1], step):
            part = a[..., k0:k0 + step] @ wf[:, k0:k0 + step].T
            out = part if out is None else out + part
        return out

    def ln(a, p):
        return F.layer_norm(a, (H,), p[0], p[1], tables["eps"])

    def heads(a):
        return a.reshape(B, T, nh, hd).transpose(1, 2)

    scale = 1.0 / math.sqrt(hd)
    cur, xb = x, x.to(bf)                 # layer 0's cast pass
    for l in range(tables["wqkv"].shape[0]):
        qkv = dot(xb, tables["wqkv"][l]) + tables["bqkv"][l]
        q = qkv[..., :H] * scale if scale_first else qkv[..., :H].to(bf).float() * scale
        qkvb = torch.cat([q, qkv[..., H:]], dim=-1).to(bf)          # the QKV epilogue's store
        q, k, v = (heads(t) for t in qkvb.split(H, dim=-1))
        s = q.float() @ k.float().transpose(-1, -2)
        p = torch.softmax(torch.where(key_ok, s, -1e30), dim=-1)
        ctxb = (p.to(bf).float() @ v.float()).transpose(1, 2).reshape(B, T, H).to(bf)
        xn = ln(cur + dot(ctxb, tables["wo"][l]) + tables["bo"][l], tables["ln1"][l])
        xnb = xn.to(bf)                                              # LN1's second output
        hbb = F.gelu(dot(xnb, tables["w1"][l]) + tables["b1"][l]).to(bf)   # the W1 epilogue's store
        cur = ln(xn + dot(hbb, tables["w2"][l]) + tables["b2"][l], tables["ln2"][l])
        xb = cur.to(bf)                                              # LN2's second output
    return cur


@pytest.mark.parametrize("hd", list(HEADS))
def test_bf16_stores_are_bit_equal_to_plain(hd):
    tables, x, vf = _case(hd)
    assert torch.equal(planned_layers(tables, x, vf), k2.encoder_layers_plain(tables, x, vf))


@pytest.mark.parametrize("hd", list(HEADS))
def test_fixed_order_split_k_within_bf16_tolerance(hd):
    tables, x, vf = _case(hd, seed=1)
    want = k2.encoder_layers_plain(tables, x, vf)
    got = planned_layers(tables, x, vf, splits=4)
    for b, n in enumerate(vf.tolist()):
        assert (got[b, :n] - want[b, :n]).abs().max().item() <= 1e-2 * want[b, :n].abs().max().item()
    assert torch.equal(got, planned_layers(tables, x, vf, splits=4))


def test_rounding_q_before_its_scale_is_caught():
    """1/sqrt(48) is no power of two, so q rounded before the scale differs
    from the plain version's rnd(q * scale) in the last bits."""
    tables, x, vf = _case(48)
    assert not torch.equal(planned_layers(tables, x, vf, scale_first=False),
                           k2.encoder_layers_plain(tables, x, vf))

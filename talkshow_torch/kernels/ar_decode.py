"""Kernel K1: the fused AR token decode of the Gated PixelCNN prior.

Wrapper of `talkshow_torch/csrc/ar_decode.cu`, which replaces the TPU
kernel `talkshow_tpu/models/pixelcnn_pallas.py:_sample_fused` (:363, body
`_make_kernel` :202-356).  What bounds it on the card and what its design
does about it are set out at the top of the CUDA source: each of the H rows
reads the whole prior (~47 MB in bf16 at full width) through ~70 dependent
GEMV steps with M = B <= 32, so the decode is latency-bound; it runs as one
cooperative persistent kernel with a grid barrier per step, weights packed
output-major for Hopper, and epilogues that fuse bias, gating, residual and
state updates.

`sample_tokens_fused` takes the arguments of the plain sampler
`talkshow_torch.models.pixelcnn.sample_tokens` (its plain PyTorch version).
A CPU tensor runs that plain version; a CUDA tensor launches the kernel or
raises — there is no fallback.  Each launch adds one to
``talkshow_torch.kernels.counts["ar_decode"]``.

The per-call conditioning stays plain PyTorch, as the JAX package computes
it outside its kernel (pixelcnn_pallas.py:380-396): the class-embedding
gather and the audio products ``aud_e @ fusion_v[dim:]`` /
``aud_e @ fusion_h[dim:]``.
"""
from __future__ import annotations

import copy
import ctypes

import torch

from talkshow_torch.kernels import TABLE_DTYPES, check, counts
from talkshow_torch.models.pixelcnn import GatedPixelCNN, sample_tokens

#: largest sample batch one launch takes (models/body.py chunks above it)
MAX_BATCH = 32
SOURCE = "talkshow_torch/csrc/ar_decode.cu"
REPLACES = "talkshow_tpu/models/pixelcnn_pallas.py:363"

_TABLE_KEYS = ("wv0", "wvB", "wv2h", "wh", "wres", "wfv", "wfh", "w1", "w2", "emb")
_BIAS_KEYS = ("bv", "bhsum", "br", "b1", "b2")

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("ar_decode")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_ar_decode_scratch.argtypes = [_I] * 5
        lib.talkshow_ar_decode_scratch.restype = ctypes.c_longlong
        lib.talkshow_ar_decode.argtypes = (
            [_I] * 7 + [_P] * 10 + [_P] * 5 + [_P] * 4 + [_U64, _P, _I]
            + [_P] * 4)
        lib.talkshow_ar_decode.restype = _I
        lib._talkshow_typed = True
    return lib


@torch.no_grad()
def pack_decode_tables(model: GatedPixelCNN,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Rearrange the prior's weights into the kernel's tables (on the
    model's device).  Label and audio conditioning is computed per call.

    Every matrix is output-major (row o holds the weights of output o):
      wv0  (2, 2d, 6d)      layer-0 vertical conv, per output column c;
                            input index (j*3 + r)*d + i = column j, row r
      wvB  (L-1, 2, 2d, 4d) layers 1.. vertical conv, (j*2 + r)*d + i
      wv2h (L, 2d, 2d)      vert_to_horiz
      wh   (L, 2d, 2d)      horizontal taps [left | self] (self = 0 at layer 0)
      wres (L, d, d), wfv/wfh (d, d) x-part of fusion_v/h,
      w1 (512, d), w2 (K, 512), emb (K, d)
    Biases stay f32: bv (L, 2d), bhsum = v2h + horizontal bias (L, 2d),
    br (L, d), b1 (512), b2 (K)."""
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
    d = model.dim

    def vert(layer):
        w = layer.vert_stack.weight                      # (2d, d, R, 3)
        cols = []
        for c in (0, 1):   # output column c reads input column j through tap j - c + 1
            cols.append(torch.cat([w[:, :, :, j - c + 1].permute(0, 2, 1).reshape(2 * d, -1)
                                   for j in (0, 1)], dim=1))
        return torch.stack(cols)

    def horiz(layer):
        w = layer.horiz_stack.weight[:, :, 0]            # (2d, d, hcols)
        self_tap = w[:, :, 1] if w.shape[-1] == 2 else torch.zeros_like(w[:, :, 0])
        return torch.cat([w[:, :, 0], self_tap], dim=1)

    layers = model.layers
    mats = dict(
        wv0=vert(layers[0]),
        wvB=torch.stack([vert(layer) for layer in layers[1:]]),
        wv2h=torch.stack([layer.vert_to_horiz.weight for layer in layers]),
        wh=torch.stack([horiz(layer) for layer in layers]),
        wres=torch.stack([layer.horiz_resid.weight for layer in layers]),
        wfv=model.fusion_v.weight[:, :d],
        wfh=model.fusion_h.weight[:, :d],
        w1=model.out_hidden.weight,
        w2=model.out_logits.weight,
        emb=model.embedding.weight,
    )
    tables = {k: v.to(dtype).contiguous() for k, v in mats.items()}
    biases = dict(
        bv=torch.stack([layer.vert_stack.bias for layer in layers]),
        bhsum=torch.stack([layer.vert_to_horiz.bias + layer.horiz_stack.bias
                           for layer in layers]),
        br=torch.stack([layer.horiz_resid.bias for layer in layers]),
        b1=model.out_hidden.bias,
        b2=model.out_logits.bias,
    )
    tables.update({k: v.float().contiguous() for k, v in biases.items()})
    return tables


@torch.no_grad()
def round_like_tables(model: GatedPixelCNN,
                      dtype: torch.dtype = torch.bfloat16) -> GatedPixelCNN:
    """A copy of `model` whose weights that enter the decode tables are
    rounded to `dtype` and back: the plain sampler on it computes in f32
    what the kernel computes from `dtype` tables."""
    m = copy.deepcopy(model)
    d = m.dim
    params = [m.fusion_v.weight[:, :d], m.fusion_h.weight[:, :d],
              m.out_hidden.weight, m.out_logits.weight, m.embedding.weight]
    for layer in m.layers:
        params += [layer.vert_stack.weight, layer.vert_to_horiz.weight,
                   layer.horiz_stack.weight, layer.horiz_resid.weight]
    for p in params:
        p.copy_(p.to(dtype).float())
    return m


@torch.no_grad()
def conditioning(model: GatedPixelCNN, label: torch.Tensor,
                 audio: torch.Tensor):
    """Per-call f32 inputs: cls (L, B, 2d), audv and audh (B, H, d), the
    audio halves of fusion_v / fusion_h with their biases."""
    d = model.dim
    cls = torch.stack([layer.class_cond_embedding.weight[label]
                       for layer in model.layers])
    aud_e = model.embedding_aud(audio)
    audv = aud_e @ model.fusion_v.weight[:, d:].T + model.fusion_v.bias
    audh = aud_e @ model.fusion_h.weight[:, d:].T + model.fusion_h.bias
    return (cls.float().contiguous(), audv.float().contiguous(),
            audh.float().contiguous())


@torch.no_grad()
def sample_tokens_fused(model: GatedPixelCNN, label: torch.Tensor,
                        audio: torch.Tensor, *, tables: dict | None = None,
                        noise: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        prefix_tokens: torch.Tensor | None = None,
                        prefix_len: int = 0, return_logits: bool = False):
    """AR decode: tokens (B, H, 2) int64 [, logits (B, H, 2, K)].

    audio (B, H, audio_channels) f32; label (B,) int.  `noise` (H, 2, B, K)
    f32 is added to the logits as given (tests pass the JAX sampler's
    gumbel block); without it the kernel draws gumbel noise with Philox,
    keyed by a 64-bit seed taken from `generator`.  `tables` come from
    `pack_decode_tables` (pack once per weight set; bf16 is the production
    type, f32 the exact one).  On a CPU tensor this is the plain sampler
    (model weights, f32; Philox is not used there: noise comes from
    `generator`)."""
    if audio.device.type == "cpu":
        return sample_tokens(model, label, audio, noise=noise,
                             generator=generator, prefix_tokens=prefix_tokens,
                             prefix_len=prefix_len, return_logits=return_logits)
    if audio.device.type != "cuda":
        raise ValueError(f"ar_decode runs on CUDA or CPU tensors, not {audio.device}")
    dev = audio.device
    B, H, _ = audio.shape
    L, d, K = model.n_layers, model.dim, model.input_dim
    hid = model.out_hidden.out_features
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside 1..{MAX_BATCH}; chunk the batch")
    if d % 8 or K % 8 or hid % 8:
        raise ValueError("dim, codebook size and head width must be multiples of 8")
    if audio.dtype != torch.float32:
        raise TypeError(f"audio must be float32, got {audio.dtype}")
    if tables is None:
        tables = pack_decode_tables(model)
    tdtype = tables["emb"].dtype
    if tdtype not in TABLE_DTYPES:
        raise TypeError(f"tables must be float32 or bfloat16, got {tdtype}")
    shapes = dict(wv0=(2, 2 * d, 6 * d), wvB=(L - 1, 2, 2 * d, 4 * d),
                  wv2h=(L, 2 * d, 2 * d), wh=(L, 2 * d, 2 * d), wres=(L, d, d),
                  wfv=(d, d), wfh=(d, d), w1=(hid, d), w2=(K, hid), emb=(K, d),
                  bv=(L, 2 * d), bhsum=(L, 2 * d), br=(L, d), b1=(hid,), b2=(K,))
    for k, shape in shapes.items():
        check(k, tables[k], shape, tdtype if k in _TABLE_KEYS else torch.float32, dev)
    label = label.to(dev)
    cls, audv, audh = conditioning(model, label, audio)
    seed = 0
    if noise is None:
        gdev = generator.device if generator is not None else "cpu"
        seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                                 device=gdev).item())
    else:
        check("noise", noise, (H, 2, B, K), torch.float32, dev)
    prefix = None
    if prefix_tokens is not None and prefix_len > 0:
        prefix = prefix_tokens.to(device=dev, dtype=torch.int32).contiguous()
        check("prefix_tokens", prefix, (B, H, 2), torch.int32, dev)
    lib = _lib()
    tokens = torch.empty((B, H, 2), dtype=torch.int32, device=dev)
    logits = (torch.empty((B, H, 2, K), dtype=torch.float32, device=dev)
              if return_logits else None)
    scratch = torch.empty(lib.talkshow_ar_decode_scratch(B, L, d, K, hid),
                          dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.talkshow_ar_decode(
            TABLE_DTYPES[tdtype], B, H, L, d, K, hid,
            *(ptr(tables[k]) for k in _TABLE_KEYS),
            *(ptr(tables[k]) for k in _BIAS_KEYS),
            ptr(cls), ptr(audv), ptr(audh), ptr(noise), seed,
            ptr(prefix), int(prefix_len) if prefix is not None else 0,
            ptr(tokens), ptr(logits), ptr(scratch), stream)
    if err != 0:
        raise RuntimeError(f"ar_decode launch failed: cudaError_t {err}")
    counts["ar_decode"] += 1
    tokens = tokens.long()
    return (tokens, logits) if return_logits else tokens

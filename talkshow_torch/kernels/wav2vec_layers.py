"""Kernel K2: the wav2vec 2.0 post-norm encoder-layer stack.

Wrapper of `talkshow_torch/csrc/wav2vec_layers.cu`, which replaces the TPU
kernel `talkshow_tpu/models/wav2vec_pallas.py:_run_layers` (:143, body
`_make_layer_kernel` :99-139).  One call runs every layer of the stack on
(B, T, H) hidden states: QKV projection, 12-head attention with keys at or
beyond `valid_frames` masked, output projection + residual + LayerNorm, the
exact-gelu FFN + residual + LayerNorm.  What bounds it on the card and what
the design does about it are set out at the top of the CUDA source.

Numerics, the same in the kernel and in `encoder_layers_plain`: both
operands of every product are rounded to the table type (bf16 in
production, f32 for exact comparison) and the sums are f32, as
`_make_layer_kernel.dot` computes them (:104-107); softmax, LayerNorm and
gelu run in f32.  With bf16 tables the kernel stores in bf16 only what the
next product rounds to bf16 anyway (qkv with q already scaled, the
attention output, the FFN hidden layer, a copy of each LayerNorm output;
`tests/test_torch_w2v_plan.py` holds that plan bit-equal to the plain
version), and its attention takes exp from the special-function unit
(~2^-21 relative).  So the two differ only in summation order and in that
last bit of exp.

`gemm_kernel` runs the Hopper GEMM that K2 and K3 share on its own, for its
tests and the smoke run's shape sweep.

A CUDA tensor launches the kernel (`encoder_layers_kernel`, one launch of
the whole stack adds one to ``counts["wav2vec_layers"]``) or raises; the
plain version (``counts["encoder_layers_plain"]``) is for CPU tensors and
for comparison.  `models/wav2vec_fused.encoder_layers_fused` picks between
them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from talkshow_torch.kernels import TABLE_DTYPES, check, counts

SOURCE = "talkshow_torch/csrc/wav2vec_layers.cu"
REPLACES = "talkshow_tpu/models/wav2vec_pallas.py:143"

_MATS = ("wqkv", "wo", "w1", "w2")
_VECS = ("bqkv", "bo", "b1", "b2", "ln1", "ln2")
#: widest hidden size the LayerNorm kernel holds in registers
MAX_HIDDEN = 1024

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: return codes from this value up are this + the CUresult of a refused tensor map
ERR_TENSOR_MAP = 10000


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("wav2vec_layers")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_w2v_layers_scratch.argtypes = [_I] * 5
        lib.talkshow_w2v_layers_scratch.restype = ctypes.c_longlong
        lib.talkshow_w2v_layers.argtypes = [_I] * 7 + [ctypes.c_float] + [_P] * 15
        lib.talkshow_w2v_layers.restype = _I
        lib.talkshow_w2v_gemm_plan.argtypes = [_I] * 5 + [_P]
        lib.talkshow_w2v_gemm_plan.restype = None
        lib.talkshow_w2v_gemm.argtypes = [_P, _L, _L, _P] + [_I] * 5 + [_P] * 2
        lib.talkshow_w2v_gemm.restype = _I
        lib._talkshow_typed = True
    return lib


@torch.no_grad()
def pack_encoder_tables(encoder, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The port's `Wav2Vec2Encoder` layer stack -> the kernel's tables, on
    the module's device.

    Every matrix keeps nn.Linear's output-major (out, in) layout and is
    stacked over layers: wqkv (L, 3H, H) = [q | k | v] rows, wo (L, H, H),
    w1 (L, F, H), w2 (L, H, F), in `dtype`.  Both GEMM operands are then
    contiguous along the reduction axis, which is what the kernel's tile
    loads and the tensor-core fragments want (no transposed copy of the
    TPU's (in, out) layout).  Biases and LayerNorm (scale, bias) pairs stay
    f32: bqkv (L, 3H), bo (L, H), b1 (L, F), b2 (L, H), ln1/ln2 (L, 2, H).
    Also carries `heads` and `eps`."""
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
    layers = encoder.encoder.layers

    def stack(fn, dt):
        return torch.stack([fn(layer) for layer in layers]).to(dt).contiguous()

    def att(layer):
        return layer.attention

    tables = dict(
        wqkv=stack(lambda m: torch.cat([att(m).q_proj.weight, att(m).k_proj.weight,
                                        att(m).v_proj.weight]), dtype),
        wo=stack(lambda m: att(m).out_proj.weight, dtype),
        w1=stack(lambda m: m.feed_forward.intermediate_dense.weight, dtype),
        w2=stack(lambda m: m.feed_forward.output_dense.weight, dtype),
        bqkv=stack(lambda m: torch.cat([att(m).q_proj.bias, att(m).k_proj.bias,
                                        att(m).v_proj.bias]), torch.float32),
        bo=stack(lambda m: att(m).out_proj.bias, torch.float32),
        b1=stack(lambda m: m.feed_forward.intermediate_dense.bias, torch.float32),
        b2=stack(lambda m: m.feed_forward.output_dense.bias, torch.float32),
        ln1=stack(lambda m: torch.stack([m.layer_norm.weight, m.layer_norm.bias]),
                  torch.float32),
        ln2=stack(lambda m: torch.stack([m.final_layer_norm.weight,
                                         m.final_layer_norm.bias]), torch.float32),
    )
    tables["heads"] = encoder.cfg.num_heads
    tables["eps"] = float(encoder.cfg.layer_norm_eps)
    return tables


def _valid(x: torch.Tensor, valid_frames) -> torch.Tensor:
    B, T, _ = x.shape
    if valid_frames is None:
        return torch.full((B,), T, dtype=torch.int32, device=x.device)
    return valid_frames.to(device=x.device, dtype=torch.int32).contiguous()


@torch.no_grad()
def encoder_layers_plain(tables: dict, x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """Plain PyTorch version of K2: (B, T, H) f32 -> (B, T, H) f32."""
    counts["encoder_layers_plain"] += 1
    dt = tables["wqkv"].dtype
    B, T, H = x.shape
    nh = tables["heads"]
    hd = H // nh
    eps = tables["eps"]
    key_ok = (torch.arange(T, device=x.device)[None] < _valid(x, valid_frames)[:, None])
    key_ok = key_ok[:, None, None, :]                               # (B, 1, 1, T)

    def rnd(a):
        return a.to(dt).float()

    def dot(a, w):                                                  # w (N, K)
        return rnd(a) @ w.float().T

    def ln(a, p):
        return F.layer_norm(a, (H,), p[0], p[1], eps)

    def heads(a):
        return a.reshape(B, T, nh, hd).transpose(1, 2)              # (B, nh, T, hd)

    x = x.float()
    for l in range(tables["wqkv"].shape[0]):
        qkv = dot(x, tables["wqkv"][l]) + tables["bqkv"][l]
        q, k, v = (heads(t) for t in qkv.split(H, dim=-1))
        s = rnd(q * (1.0 / math.sqrt(hd))) @ rnd(k).transpose(-1, -2)
        p = torch.softmax(torch.where(key_ok, s, -1e30), dim=-1)
        ctx = (rnd(p) @ rnd(v)).transpose(1, 2).reshape(B, T, H)
        xn = ln(x + dot(ctx, tables["wo"][l]) + tables["bo"][l], tables["ln1"][l])
        hb = F.gelu(dot(xn, tables["w1"][l]) + tables["b1"][l])
        x = ln(xn + dot(hb, tables["w2"][l]) + tables["b2"][l], tables["ln2"][l])
    return x


@torch.no_grad()
def encoder_layers_kernel(tables: dict, x: torch.Tensor, valid_frames=None) -> torch.Tensor:
    """K2 on the card: (B, T, H) f32 CUDA tensor -> (B, T, H) f32.  Rows at
    or beyond valid_frames[b] are computed too (they attend to the valid
    keys) and stay finite."""
    if x.device.type != "cuda":
        raise ValueError(f"wav2vec_layers runs on CUDA tensors, not {x.device}")
    dev = x.device
    B, T, H = x.shape
    tdtype = tables["wqkv"].dtype
    if tdtype not in TABLE_DTYPES:
        raise TypeError(f"tables must be float32 or bfloat16, got {tdtype}")
    L, F_ = tables["wqkv"].shape[0], tables["w1"].shape[1]
    nh = tables["heads"]
    step = 8 if tdtype == torch.bfloat16 else 4
    if H % nh or H // nh > 128 or (H // nh) % step or H % 8 or F_ % 8 or H > MAX_HIDDEN:
        raise ValueError(f"hidden {H} (at most {MAX_HIDDEN}) and FFN {F_} must be multiples of 8 "
                         f"and split into {nh} heads of at most 128, a multiple of {step} wide")
    shapes = dict(wqkv=(L, 3 * H, H), wo=(L, H, H), w1=(L, F_, H), w2=(L, H, F_),
                  bqkv=(L, 3 * H), bo=(L, H), b1=(L, F_), b2=(L, H),
                  ln1=(L, 2, H), ln2=(L, 2, H))
    for k, shape in shapes.items():
        check(k, tables[k], shape, tdtype if k in _MATS else torch.float32, dev)
    check("x", x, (B, T, H), torch.float32, dev)
    valid = _valid(x, valid_frames)
    lib = _lib()
    out = torch.empty_like(x)
    scratch = torch.empty(lib.talkshow_w2v_layers_scratch(TABLE_DTYPES[tdtype], B, T, H, F_),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.talkshow_w2v_layers(
            TABLE_DTYPES[tdtype], B, T, H, nh, F_, L, tables["eps"],
            *(tables[k].data_ptr() for k in _MATS + _VECS),
            valid.data_ptr(), x.data_ptr(), out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wav2vec_layers launch failed: {describe_error(err)}")
    counts["wav2vec_layers"] += 1
    return out


def describe_error(err: int) -> str:
    """A C entry's return code in words."""
    if err >= ERR_TENSOR_MAP:
        return f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - ERR_TENSOR_MAP})"
    return f"cudaError_t {err}"


def gemm_plan(M: int, N: int, K: int, Z: int = 1, splits: int = 0) -> tuple[int, int, int]:
    """The Hopper GEMM's plan for this shape: (consumer warpgroups, each
    64 rows of a 128-column tile; split-K count; 64-wide k tiles per
    split).  `splits` > 0 forces the split count, as `gemm_kernel` does."""
    plan = (ctypes.c_int * 3)()
    _lib().talkshow_w2v_gemm_plan(M, N, K, Z, splits, plan)
    return tuple(plan)


@torch.no_grad()
def gemm_kernel(a: torch.Tensor, w: torch.Tensor, M: int, lda: int, a_batch: int = 0,
                Z: int = 1, splits: int = 0) -> torch.Tensor:
    """The Hopper GEMM that K2 and K3 share, alone (for its tests and the
    smoke run's shape sweep): (Z, M, N) f32 = A W^T, A row m of batch z the
    K bf16 values at a[z * a_batch + m * lda:], which may overlap as a
    strided conv's rows do; w (N, K) bf16.  `splits` 0 lets the plan pick
    split-K, > 0 forces that many splits.  A CUDA tensor or raises."""
    if a.device.type != "cuda":
        raise ValueError(f"the GEMM runs on CUDA tensors, not {a.device}")
    N, K = w.shape
    for name, t in (("a", a), ("w", w)):
        check(name, t, tuple(t.shape), torch.bfloat16, a.device)
    reach = (Z - 1) * a_batch + (M - 1) * lda + K
    if a.dim() != 1 or a.numel() < reach:
        raise ValueError(f"a must be flat and hold {reach} values, not {tuple(a.shape)}")
    lib = _lib()
    out = torch.empty((Z, M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.talkshow_w2v_gemm(a.data_ptr(), lda, a_batch, w.data_ptr(), M, N, K, Z,
                                    splits, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wav2vec GEMM launch failed: {describe_error(err)}")
    return out

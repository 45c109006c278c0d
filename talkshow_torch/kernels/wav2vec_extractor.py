"""Kernel K3: the wav2vec 2.0 raw-waveform conv feature extractor.

Wrapper of `talkshow_torch/csrc/wav2vec_extractor.cu`, which replaces the
TPU kernel `talkshow_tpu/models/wav2vec_pallas.py:_run_extractor` (:405,
body `_make_extractor_kernel` :323-400): layer 0 is a VALID conv 1 -> C
(k10/s5 in wav2vec 2.0 base), per-channel GroupNorm over the whole time
axis, gelu; then VALID strided convs (six k3|k2 / s2 in base), each
followed by gelu.  Unmasked: every frame of the clip is valid.  What bounds
it on the card and what the design does about it are set out at the top of
the CUDA source.

Numerics, the same in the kernel and in `extractor_plain`: the waveform
and the weights are rounded to the table type (bf16 in production, f32 for
exact comparison) and the sums are f32; GroupNorm statistics are f32, over
the f32 layer-0 output; every layer's output is rounded to the table type
after its gelu, as the TPU kernel stores its intermediates (:373, :395),
and the last one comes back as f32.

WavLM's LayerNorm mode (an extractor whose `feat_extract_norm` is
"layer"; the tables carry ``ln``): every conv is followed by a LayerNorm
over the channels of each frame (f32 statistics of the f32 conv output), then gelu and the same
rounding.  Its launches also add one to ``counts["extractor_layernorm"]``.

A CUDA tensor launches the kernel (`extractor_kernel`, one launch of the
whole stack adds one to ``counts["wav2vec_extractor"]``) or raises; the
plain version (``counts["extractor_plain"]``) is for CPU tensors and for
comparison.  `models/wav2vec_fused.extractor_fused` picks between them by
the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from talkshow_torch.kernels import TABLE_DTYPES, check, counts
from talkshow_torch.kernels.wav2vec_layers import describe_error

SOURCE = "talkshow_torch/csrc/wav2vec_extractor.cu"
REPLACES = "talkshow_tpu/models/wav2vec_pallas.py:405"

#: longest layer-0 kernel the CUDA code takes
MAX_K0 = 16

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("wav2vec_extractor")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_w2v_extractor_scratch.argtypes = [_I] * 4 + [_P]
        lib.talkshow_w2v_extractor_scratch.restype = ctypes.c_longlong
        lib.talkshow_w2v_extractor.argtypes = [_I] * 4 + [_P, ctypes.c_float] + [_P] * 7
        lib.talkshow_w2v_extractor.restype = _I
        lib.talkshow_w2v_extractor_ln_scratch.argtypes = [_I] * 4 + [_P]
        lib.talkshow_w2v_extractor_ln_scratch.restype = ctypes.c_longlong
        lib.talkshow_w2v_extractor_ln.argtypes = [_I] * 4 + [_P, ctypes.c_float] + [_P] * 7
        lib.talkshow_w2v_extractor_ln.restype = _I
        lib._talkshow_typed = True
    return lib


@torch.no_grad()
def pack_extractor_tables(extractor, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The port's `FeatureExtractor` -> the kernel's tables, on its device.

    w0 (C0, k0) in `dtype`: layer 0's taps per output channel.  ws: every
    later layer's (C_out, k * C_in) matrix in `dtype`, tap-major along a
    row (index j * C_in + c), flattened and concatenated.  With activations
    stored channels-last, output frame t of a stride-s layer reads the
    k * C_in contiguous values starting at frame s * t, in that same order,
    so the conv is a GEMM whose A rows overlap with stride s * C_in: no
    im2col copy and no polyphase reordering.  gn (2, C0) f32 GroupNorm
    scale and bias.  `layers` lists (kernel, stride, C_out) per layer and
    `eps` the GroupNorm epsilon."""
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
    convs = [layer.conv for layer in extractor.conv_layers]
    norm = extractor.conv_layers[0].layer_norm
    w0 = convs[0].weight[:, 0, :]                                   # (C0, k0)
    ws = [c.weight.permute(0, 2, 1).reshape(c.out_channels, -1).flatten()
          for c in convs[1:]]
    tables = dict(
        w0=w0.to(dtype).contiguous(),
        ws=torch.cat(ws).to(dtype).contiguous() if ws else w0.new_zeros(0, dtype=dtype),
        layers=tuple((c.kernel_size[0], c.stride[0], c.out_channels) for c in convs),
        eps=float(norm.eps),
    )
    if getattr(extractor, "layer_norm_all", False):
        # every layer's (2, C) LayerNorm, concatenated
        tables["ln"] = torch.cat([torch.stack([l.layer_norm.weight, l.layer_norm.bias]).flatten()
                                  for l in extractor.conv_layers]).float().contiguous()
    else:
        tables["gn"] = torch.stack([norm.weight, norm.bias]).float().contiguous()
    return tables


def out_length(num_samples: int, tables: dict) -> int:
    """Frames out of the VALID conv stack for a clip of num_samples."""
    n = num_samples
    for k, s, _ in tables["layers"]:
        n = (n - k) // s + 1
    return n


@torch.no_grad()
def extractor_plain(tables: dict, wave: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: (B, N) f32 -> (B, T_out, C) f32."""
    counts["extractor_plain"] += 1
    dt = tables["w0"].dtype

    def rnd(a):
        return a.to(dt).float()

    (k0, s0, c0), rest = tables["layers"][0], tables["layers"][1:]
    if "ln" in tables:
        return _ln_plain(tables, rnd(wave), rnd)
    h = F.conv1d(rnd(wave)[:, None, :], tables["w0"].float()[:, None, :], stride=s0)
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    gn = tables["gn"]
    h = (h - mean) * torch.rsqrt(var + tables["eps"]) * gn[0][:, None] + gn[1][:, None]
    h = rnd(F.gelu(h))
    off, cin = 0, c0
    for k, s, cout in rest:
        n = cout * k * cin
        w = tables["ws"][off:off + n].float().reshape(cout, k, cin).permute(0, 2, 1)
        h = rnd(F.gelu(F.conv1d(h, w, stride=s)))
        off, cin = off + n, cout
    return h.transpose(1, 2).contiguous()


def _ln_plain(tables: dict, wave: torch.Tensor, rnd) -> torch.Tensor:
    """extractor_plain's LayerNorm mode on the rounded waveform."""
    h, off, cin = wave[:, None, :], 0, 1
    lo = 0
    for i, (k, s, cout) in enumerate(tables["layers"]):
        if i == 0:
            w = tables["w0"].float()[:, None, :]
        else:
            n = cout * k * cin
            w = tables["ws"][off:off + n].float().reshape(cout, k, cin).permute(0, 2, 1)
            off += n
        h = F.conv1d(h, w, stride=s).transpose(1, 2)
        g, b = tables["ln"][lo:lo + 2 * cout].view(2, cout)
        h = rnd(F.gelu(F.layer_norm(h, (cout,), g, b, tables["eps"]))).transpose(1, 2)
        lo, cin = lo + 2 * cout, cout
    return h.transpose(1, 2).contiguous()


@torch.no_grad()
def extractor_kernel(tables: dict, wave: torch.Tensor) -> torch.Tensor:
    """K3 on the card: (B, N) f32 CUDA tensor -> (B, T_out, C) f32."""
    if wave.device.type != "cuda":
        raise ValueError(f"wav2vec_extractor runs on CUDA tensors, not {wave.device}")
    dev = wave.device
    B, N = wave.shape
    tdtype = tables["w0"].dtype
    if tdtype not in TABLE_DTYPES:
        raise TypeError(f"tables must be float32 or bfloat16, got {tdtype}")
    layers = tables["layers"]
    k0, _, c0 = layers[0]
    if k0 > MAX_K0 or not 2 <= len(layers) <= 16 or any(c % 8 for _, _, c in layers):
        raise ValueError(f"the kernel takes 2 to 16 conv layers of a multiple of 8 channels "
                         f"and a layer-0 kernel of at most {MAX_K0} taps, not {layers}")
    T_out = out_length(N, tables)
    if T_out < 1:
        raise ValueError(f"a clip of {N} samples is shorter than the conv stack's reach")
    n_ws, cin = 0, c0
    for k, _, cout in layers[1:]:
        n_ws, cin = n_ws + cout * k * cin, cout
    check("w0", tables["w0"], (c0, k0), tdtype, dev)
    check("ws", tables["ws"], (n_ws,), tdtype, dev)
    ln = "ln" in tables
    n_ch = sum(c for _, _, c in layers)
    if ln:
        check("ln", tables["ln"], (2 * n_ch,), torch.float32, dev)
    else:
        check("gn", tables["gn"], (2, c0), torch.float32, dev)
    check("wave", wave, (B, N), torch.float32, dev)
    lib = _lib()
    dims = (ctypes.c_int * (3 * len(layers)))(*(v for layer in layers for v in layer))
    out = torch.empty((B, T_out, layers[-1][2]), dtype=torch.float32, device=dev)
    sizer = lib.talkshow_w2v_extractor_ln_scratch if ln else lib.talkshow_w2v_extractor_scratch
    nbytes = sizer(TABLE_DTYPES[tdtype], B, N, len(layers), dims)
    if nbytes < 0:
        raise ValueError(f"the kernel does not take the conv layers {layers}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ln:
            err = lib.talkshow_w2v_extractor_ln(
                TABLE_DTYPES[tdtype], B, N, len(layers), dims, tables["eps"],
                tables["w0"].data_ptr(), tables["ws"].data_ptr(), tables["ln"].data_ptr(),
                wave.data_ptr(), out.data_ptr(), scratch.data_ptr(), stream)
        else:
            err = lib.talkshow_w2v_extractor(
                TABLE_DTYPES[tdtype], B, N, len(layers), dims, tables["eps"],
                tables["w0"].data_ptr(), tables["ws"].data_ptr(), tables["gn"].data_ptr(),
                wave.data_ptr(), out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wav2vec_extractor launch failed: {describe_error(err)}")
    counts["wav2vec_extractor"] += 1
    if ln:
        counts["extractor_layernorm"] += 1
    return out

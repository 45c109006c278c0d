"""Kernel K1: the fused AR token decode of the Gated PixelCNN prior.

Wrapper of `talkshow_torch/csrc/ar_decode.cu`, which replaces the TPU
kernel `talkshow_tpu/models/pixelcnn_pallas.py:_sample_fused` (:363, body
`_make_kernel` :202-356).  What bounds it on the card and what its design
does about it are set out at the top of the CUDA source: each of the H rows
is a chain of ~70 dependent GEMV steps with M = B <= 32, so the decode is
latency-bound.  One launch holds two roles: the vertical stack and v2h on
most of the card, and the horizontal chain, the head and the sampling on
one thread-block cluster of CLUSTER = 16 CTAs, fed by asynchronous bulk
copies of the weight streams laid out here (`chain_parts`,
`pack_decode_tables`).  Past 8 samples, with bf16 tables, the chain's
products run on the tensor cores (the kernel picks this from B).

`sample_tokens_fused` takes the arguments of the plain sampler
`talkshow_torch.models.pixelcnn.sample_tokens` (its plain PyTorch version).
A CPU tensor runs that plain version; a CUDA tensor launches the kernel or
raises — there is no fallback.  A batch whose chain buffers would leave the
weight ring fewer than 4 stages of shared memory (past 23 samples at the
6-D prior's dim 512, `launch_plan` / `max_batch`, a transcription of the
kernel's carve) raises before the launch and names the largest batch that
fits.  Each launch adds one to
``talkshow_torch.kernels.counts["ar_decode"]`` and records its shape in
`last_launch`.

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
from talkshow_torch.models.pixelcnn import GatedPixelCNN, check_sampleable, sample_tokens
from talkshow_torch.tracing import span

#: most sample batch rows one launch takes (the argmax's lanes); at a given
#: shape the chain's shared memory may hold fewer (`max_batch`), and
#: models/body.py chunks above that
MAX_BATCH = 32
SOURCE = "talkshow_torch/csrc/ar_decode.cu"
REPLACES = "talkshow_tpu/models/pixelcnn_pallas.py:363"

#: CTAs of the chain's cluster (csrc/ar_decode.cu kCluster)
CLUSTER = 16
#: the chain's ring stage (one bulk copy) and the longest part of a step
CHUNK_BYTES = 16384
PART_BYTES = 32768
#: step kinds of the chain (csrc/ar_decode.cu kStep*) and part flags
GATED, RESID, FUSION, HIDDEN, LOGITS = range(5)
FIRST, LAST = 1, 2

_TABLE_KEYS = ("wv0", "wvB", "wv2h", "wfv", "emb", "chain")
_BIAS_KEYS = ("bv", "bhsum", "br", "b1", "b2")

#: the shape of the last launch: CTAs per role, shared memory per CTA and
#: ring stages
last_launch: dict = {}

_P, _I, _LL, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64


def _lib() -> ctypes.CDLL:
    from talkshow_torch.kernels import _build
    lib = _build.load("ar_decode")
    if not getattr(lib, "_talkshow_typed", False):
        lib.talkshow_ar_decode_scratch.argtypes = [_I] * 3
        lib.talkshow_ar_decode_scratch.restype = _LL
        lib.talkshow_ar_decode.argtypes = (
            [_I] * 9 + [_P, _I, _LL] + [_P] * 6 + [_P] * 5 + [_P] * 4 + [_U64, _P, _I]
            + [_P] * 4 + [_LL, _P, _P])
        lib.talkshow_ar_decode.restype = _I
        lib.talkshow_ar_decode_error.argtypes = [_I]
        lib.talkshow_ar_decode_error.restype = ctypes.c_char_p
        lib._talkshow_typed = True
    return lib


def chain_steps(L: int, d: int, K: int, hid: int):
    """The chain's steps of one token row, in order: (kind, column, layer,
    row length, outputs, rows per unit).  A gated unit is the pair of rows
    j, j + d of wh[l] over the taps the column reads (column 0: its own
    x_h, none at layer 0; column 1: [left | self], the left one only at
    layer 0)."""
    steps = []
    for c in (0, 1):
        for l in range(L):
            klen = (0 if l == 0 else d) if c == 0 else (d if l == 0 else 2 * d)
            steps.append((GATED, c, l, klen, d, 2))
            steps.append((RESID, c, l, d, d, 1))
            if l == 0:
                steps.append((FUSION, c, 0, d, d, 1))
        steps.append((HIDDEN, c, L, d, hid, 1))
        steps.append((LOGITS, c, L, hid, K, 1))
    return steps


def chain_parts(L: int, d: int, K: int, hid: int, esize: int):
    """Parts of the chain's steps and the length of each CTA's weight stream
    per token row, in elements.

    CTA q of the cluster owns outputs [q n/C, (q + 1) n/C) of a step with n
    outputs; its stream holds its rows of every step in order.  A step is
    cut into parts of whole units of at most PART_BYTES, which the kernel
    waits for, computes and releases one by one.  A part is (kind, column,
    layer, row length, first unit, units, stream offset, flags FIRST/LAST);
    the stream is padded to whole CHUNK_BYTES."""
    parts, off = [], 0
    for kind, c, l, klen, n, urows in chain_steps(L, d, K, hid):
        per_cta = n // CLUSTER
        ubytes = urows * klen * esize
        per_part = max(1, PART_BYTES // ubytes) if ubytes else per_cta
        for u0 in range(0, per_cta, per_part):
            nu = min(per_part, per_cta - u0)
            flags = (FIRST if u0 == 0 else 0) | (LAST if u0 + nu == per_cta else 0)
            parts.append((kind, c, l, klen, u0, nu, off, flags))
            off += nu * urows * klen
    chunk = CHUNK_BYTES // esize
    return parts, -(-off // chunk) * chunk


#: shared memory a CTA may take on sm_90, the ring's most stages and the
#: warps of a CTA (csrc/ar_decode.cu kSmemCap, kMaxStages, kWarps)
SMEM_CAP = 227 * 1024
MAX_STAGES = 32
_WARPS = 16


def chain_smem_bytes(B: int, L: int, d: int, hid: int, K: int, nparts: int,
                     cls_smem: bool, nst: int) -> int:
    """The chain CTA's shared memory in bytes: the carve of `chain_smem` in
    csrc/ar_decode.cu, field by field, in its order and alignments."""
    o = 0

    def take(nbytes: int, align: int) -> None:
        nonlocal o
        o = -(-o // align) * align + nbytes

    C = CLUSTER
    n_own, h_own = d // C, hid // C
    take(B * (max(2 * d, hid) + 4) * 4, 16)                   # x, the step's input
    take((L + 1) * B * n_own * 4, 16)                         # hist0
    for _ in range(3):                                        # xh1, gs, tmp
        take(B * n_own * 4, 16)
    take(B * h_own * 4, 16)                                   # head hidden
    take(B * (K // C) * 4, 16)                                # gumbel noise
    take(MAX_BATCH * 4, 16)                                   # cval
    take(MAX_BATCH * 4, 16)                                   # cidx
    take(_WARPS * 32 * 4, 16)                                 # wval
    take(_WARPS * 32 * 4, 16)                                 # widx
    take(3 * MAX_BATCH * 2 * 4, 16)                           # tokens of rows r-2 .. r
    take(nparts * 32, 16)                                     # part descriptors
    take((3 * L * n_own + h_own + K // C) * 4, 16)            # biases
    take(L * B * 2 * n_own * 4 if cls_smem else 0, 16)        # cls
    take(L * B * 2 * n_own * 4 if cls_smem else 0, 16)        # column 1's v2h
    take(MAX_STAGES * 8, 8)                                   # mbarriers
    take(nst * CHUNK_BYTES, 128)                              # the ring
    return o


def launch_plan(B: int, L: int, d: int, K: int, hid: int, esize: int,
                smem_cap: int = SMEM_CAP) -> dict | None:
    """The chain's carve that the launch would choose (csrc/ar_decode.cu
    `decode`: the ring takes what the buffers leave, cls and column 1's v2h
    move to shared memory while the ring keeps 12 stages, and a part must
    fit beside the chunk it may start in): {'cls_smem', 'ring_stages',
    'smem_bytes'}, or None when the batch's buffers leave the ring too few
    stages.  `smem_cap`: the card's opt-in limit per block."""
    nparts = len(chain_parts(L, d, K, hid, esize)[0])
    cap = min(smem_cap, SMEM_CAP)

    def stages(cls_smem: bool) -> int:
        fixed = chain_smem_bytes(B, L, d, hid, K, nparts, cls_smem, 0)
        return min(MAX_STAGES, (cap - -(-fixed // 128) * 128) // CHUNK_BYTES)

    cls_smem = stages(True) >= 12
    nst = stages(cls_smem)
    if nst * CHUNK_BYTES < PART_BYTES + 2 * CHUNK_BYTES:
        return None
    return dict(cls_smem=cls_smem, ring_stages=nst,
                smem_bytes=chain_smem_bytes(B, L, d, hid, K, nparts, cls_smem, nst))


def max_batch(L: int, d: int, K: int, hid: int, esize: int,
              smem_cap: int = SMEM_CAP) -> int:
    """The largest sample batch one launch takes at this shape (MAX_BATCH
    where it fits; at dim 512 the chain's buffers fill shared memory sooner),
    0 when none does."""
    return next((B for B in range(MAX_BATCH, 0, -1)
                 if launch_plan(B, L, d, K, hid, esize, smem_cap) is not None), 0)


def model_max_batch(model: GatedPixelCNN, dtype: torch.dtype = torch.bfloat16,
                    smem_cap: int = SMEM_CAP) -> int:
    """`max_batch` for `model`'s decode with `dtype` tables."""
    return max_batch(model.n_layers, model.dim, model.input_dim,
                     model.out_hidden.out_features,
                     torch.empty((), dtype=dtype).element_size(), smem_cap)


def _smem_cap(dev: torch.device) -> int:
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_CAP))


@torch.no_grad()
def pack_decode_tables(model: GatedPixelCNN, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Rearrange the prior's weights into the kernel's tables (on the
    model's device).  Label and audio conditioning is computed per call.

    The vertical group's matrices are output-major (row o holds the weights
    of output o):
      wv0  (2, 2d, 6d)      layer-0 vertical conv, per output column c;
                            input index (j*3 + r)*d + i = column j, row r
      wvB  (L-1, 2, 2d, 4d) layers 1.. vertical conv, (j*2 + r)*d + i
      wv2h (L, 2d, 2d)      vert_to_horiz
      wfv  (d, d)           x-part of fusion_v
      emb  (K, d)
    The chain's, `chain` (CLUSTER, row_elems): CTA q's rows of wh (the
    horizontal taps), wres, the x-part of fusion_h, w1 (512, d) and
    w2 (K, 512), in the order of `chain_parts`, whose descriptors are
    `parts` (int32, (n, 8)).  Biases stay f32: bv (L, 2d), bhsum = v2h +
    horizontal bias (L, 2d), br (L, d), b1 (512), b2 (K).  The kernel runs
    the bh_model=True data flow: a bh_model=False prior raises ValueError,
    as JAX's `supports_fused` refuses it (pixelcnn_pallas.py:75-80)."""
    check_sampleable(model)
    if dtype not in TABLE_DTYPES:
        raise ValueError(f"table dtype must be float32 or bfloat16, got {dtype}")
    d, L, K = model.dim, model.n_layers, model.input_dim
    hid = model.out_hidden.out_features
    C = CLUSTER
    if d % C or hid % C or K % C:
        raise ValueError(f"dim {d}, head {hid} and codebook {K} must be multiples of the "
                         f"chain's cluster of {C} CTAs")

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
        wfv=model.fusion_v.weight[:, :d],
        emb=model.embedding.weight,
    )
    tables = {k: v.to(dtype).contiguous() for k, v in mats.items()}

    # the chain's streams: per step a (C, rows of CTA q) block, then padding
    blocks = []
    for kind, c, l, klen, _, _ in chain_steps(L, d, K, hid):
        if kind == GATED:
            k0 = d if c == 0 else 0                  # column 0 reads its own tap only
            w = horiz(layers[l])[:, k0:k0 + klen]
            w = w.reshape(2, C, d // C, klen).permute(1, 2, 0, 3)   # pair j: rows j, j + d
        elif kind == RESID:
            w = layers[l].horiz_resid.weight
        elif kind == FUSION:
            w = model.fusion_h.weight[:, :d]
        else:
            w = model.out_hidden.weight if kind == HIDDEN else model.out_logits.weight
        blocks.append(w.to(dtype).reshape(C, -1))
    parts, row_elems = chain_parts(L, d, K, hid, torch.empty((), dtype=dtype).element_size())
    chain = torch.cat(blocks, dim=1)
    tables["chain"] = torch.nn.functional.pad(chain, (0, row_elems - chain.shape[1])).contiguous()
    tables["parts"] = torch.tensor(parts, dtype=torch.int32, device=chain.device)
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
    `generator`).  A launch the card cannot hold (the cluster cannot be
    co-scheduled beside the rest of the grid) raises RuntimeError; a
    bh_model=False prior raises ValueError on either device.  Traced as the
    span ``ar_decode`` (B, H, noise_given)."""
    check_sampleable(model)
    with span("ar_decode", B=audio.shape[0], H=audio.shape[1], noise_given=noise is not None):
        if audio.device.type == "cpu":
            return sample_tokens(model, label, audio, noise=noise,
                                 generator=generator, prefix_tokens=prefix_tokens,
                                 prefix_len=prefix_len, return_logits=return_logits)
        return _decode(model, label, audio, tables, noise, generator, prefix_tokens,
                       prefix_len, return_logits)


def _decode(model, label, audio, tables, noise, generator, prefix_tokens, prefix_len,
            return_logits, trace=None):
    """The launch behind `sample_tokens_fused` for CUDA tensors; `trace`
    (int64, `timeline_size` long) receives the timeline probe."""
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
    esize = tables["emb"].element_size()
    if launch_plan(B, L, d, K, hid, esize, _smem_cap(dev)) is None:
        raise ValueError(
            f"batch {B} does not fit one launch at dim {d}, {L} layers, {K} codes with "
            f"{tdtype} tables: the chain's buffers leave its weight ring fewer than 4 "
            f"stages of shared memory; the largest batch that fits is "
            f"{max_batch(L, d, K, hid, esize, _smem_cap(dev))}: chunk the batch")
    parts, row_elems = chain_parts(L, d, K, hid, esize)
    shapes = dict(wv0=(2, 2 * d, 6 * d), wvB=(L - 1, 2, 2 * d, 4 * d),
                  wv2h=(L, 2 * d, 2 * d), wfv=(d, d), emb=(K, d), chain=(CLUSTER, row_elems),
                  bv=(L, 2 * d), bhsum=(L, 2 * d), br=(L, d), b1=(hid,), b2=(K,))
    for k, shape in shapes.items():
        check(k, tables[k], shape, tdtype if k in _TABLE_KEYS else torch.float32, dev)
    check("parts", tables["parts"], (len(parts), 8), torch.int32, dev)
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
    scratch = torch.empty(lib.talkshow_ar_decode_scratch(B, L, d), dtype=torch.float32,
                          device=dev)
    info = (ctypes.c_int * 4)()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.talkshow_ar_decode(
            TABLE_DTYPES[tdtype], B, H, L, d, K, hid, CHUNK_BYTES, PART_BYTES,
            ptr(tables["parts"]), len(parts), row_elems * tables["emb"].element_size(),
            *(ptr(tables[k]) for k in _TABLE_KEYS),
            *(ptr(tables[k]) for k in _BIAS_KEYS),
            ptr(cls), ptr(audv), ptr(audh), ptr(noise), seed,
            ptr(prefix), int(prefix_len) if prefix is not None else 0,
            ptr(tokens), ptr(logits), ptr(scratch), ptr(trace), H * _chain_stride(L),
            ctypes.addressof(info), stream)
    if err != 0:
        name = lib.talkshow_ar_decode_error(err).decode()
        raise RuntimeError(f"ar_decode launch failed: cudaError_t {err} ({name}), "
                           f"cluster {CLUSTER}, B={B}")
    counts["ar_decode"] += 1
    last_launch.update(chain_ctas=info[0], vertical_ctas=info[1], smem_bytes=info[2],
                       ring_stages=info[3])
    tokens = tokens.long()
    return (tokens, logits) if return_logits else tokens


def _chain_stride(L: int) -> int:
    """Timeline entries per row of the chain: its start, the end of each of
    its steps, its end, its wait for v2h, its time gathering the steps'
    inputs and waiting for weight chunks (the vertical group's: its start,
    the end of each of its L + 2 phases, its wait for "row sampled")."""
    return len(chain_steps(L, 1, 1, 1)) + 5


@torch.no_grad()
def decode_timeline(model: GatedPixelCNN, label: torch.Tensor, audio: torch.Tensor,
                    tables: dict, generator: torch.Generator | None = None) -> dict:
    """One decode (Philox noise) with the kernel's %globaltimer probe on:
    the mean over token rows 1.. of the row's time, the chain's steps by
    kind and column, the chain's wait for v2h, its time gathering the
    steps' inputs (DSMEM, with the gumbel noise) and waiting for weight
    chunks (the ring's bulk copies), the vertical group's phases
    and its wait for the previous row's tokens, in microseconds."""
    H = audio.shape[1]
    L, K, d = model.n_layers, model.input_dim, model.dim
    S, V = _chain_stride(L), L + 4
    trace = torch.zeros(H * (S + V), dtype=torch.int64, device=audio.device)
    _decode(model, label, audio, tables, None, generator, None, 0, False, trace)
    t = trace.cpu().double()
    chain, vert = t[:H * S].view(H, S)[1:], t[H * S:].view(H, V)[1:]
    steps = chain_steps(L, d, K, model.out_hidden.out_features)
    n = len(steps)
    dur = (chain[:, 1:n + 1] - chain[:, :n]).mean(0) / 1e3
    out = {"row_us": float((chain[:, n + 1] - chain[:, 0]).mean() / 1e3),
           "v2h_wait_us": float(chain[:, n + 2].mean() / 1e3),
           "input_us": float(chain[:, n + 3].mean() / 1e3),
           "ring_wait_us": float(chain[:, n + 4].mean() / 1e3),
           "row_end_us": float((chain[:, n + 1] - chain[:, n]).mean() / 1e3),
           "vertical_phases_us": float((vert[:, V - 2] - vert[:, 0]).mean() / 1e3),
           "vertical_phase_us": float(((vert[:, 1:V - 1] - vert[:, :V - 2]).mean()) / 1e3),
           "vertical_row_wait_us": float(vert[:, V - 1].mean() / 1e3)}
    names = {GATED: "gated", RESID: "resid", FUSION: "fusion", HIDDEN: "hidden",
             LOGITS: "logits"}
    for c in (0, 1):
        idx = [i for i, st in enumerate(steps) if st[1] == c]
        out[f"col{c}_us"] = float(dur[idx].sum())
        for kind, name in names.items():
            sel = [i for i in idx if steps[i][0] == kind]
            out[f"col{c}_{name}_us"] = float(dur[sel].mean())
    return out

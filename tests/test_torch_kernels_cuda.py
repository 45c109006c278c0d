"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU:
K1 (csrc/ar_decode.cu), K2 (csrc/wav2vec_layers.cu), K3
(csrc/wav2vec_extractor.cu) and K4 (csrc/nearest_code.cu).  Every test skips where CUDA is absent: the
kernels have no CPU mode.  Imports no JAX, so it runs on a machine with the
card and PyTorch only:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: K1's f32 tables agree with the plain version to 1e-3 in the
logits (the same f32 math, summed in another order through 15 layers);
bf16 tables are compared with the plain version fed the same bf16-rounded
weights, so only the summation order differs there too (and past 8 batch
rows, where the chain's products run on the tensor cores, x's split into
bf16 hi + lo, 2^-17 of it): within 1e-3 of max|logit|.  K2 and K3 round
the operands of every product to the table type on both sides, so they
too differ only in summation order: f32 tables within 1e-3 (12 post-norm
layers; a 32 000-frame GroupNorm), bf16 tables within 1e-2 of the output's
largest magnitude (an intermediate rounded to bf16 on one side may round
the other way on the other, one bf16 ulp = 2**-8 of its value).  Rows at
or past valid_frames must stay finite.  K4 sums the same f32 products in
another order than the plain matmul: its indices equal the plain version's
except on near-tie rows (best and second-best distances within
1e-5 (1 + |best|)), and every pick lies within that tolerance of the row's
minimum distance.  The Hopper GEMM that K2 and K3 share is held alone to
torch.matmul on the same bf16 operands in f32 (TF32 off): only the order of
the f32 sums differs, so within 1e-4 of max|C|.  A short MotionServer
flush on the card (f32 tables) serves the motion of the same flush on the
CPU, on the same weights and noise, within 1e-3 (chip_smoke.py phase 4's
tolerance for `generate`).
"""
import numpy as np
import pytest
import torch

from talkshow_torch.kernels import ar_decode, counts
from talkshow_torch.kernels import wav2vec_extractor as k3
from talkshow_torch.kernels import wav2vec_layers as k2
from talkshow_torch.kernels.ar_decode import (pack_decode_tables, round_like_tables,
                                              sample_tokens_fused)
from talkshow_torch.kernels.nearest_code import (nearest_code_kernel, nearest_code_plain,
                                                 search_plan)
from talkshow_torch.ops import vq as vq_ops
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.pixelcnn import GatedPixelCNN, sample_tokens
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder

SHAPES = [  # dim, layers, K, B, H
    (16, 4, 32, 3, 7),
    (256, 15, 2048, 8, 75),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dim, layers, K, B, H, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(GatedPixelCNN(input_dim=K, dim=dim, n_layers=layers,
                                        audio_channels=256), gen)
    with torch.no_grad():   # non-zero biases, so every bias path is exercised
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    model = model.to(device).eval()
    label = torch.randint(0, 4, (B,), generator=gen).to(device)
    audio = torch.randn((B, H, 256), generator=gen).to(device)
    given = torch.randint(0, K, (B, H, 2), generator=gen).to(device)
    noise = -torch.log(-torch.log(torch.rand((H, 2, B, K), generator=gen).clamp_min(1e-30)))
    return model, label, audio, given, noise.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_f32_tables_match_plain(cuda, shape):
    model, label, audio, given, noise = _case(*shape, cuda)
    H = shape[4]
    tables = pack_decode_tables(model, torch.float32)
    counts.clear()
    tok = sample_tokens_fused(model, label, audio, tables=tables, noise=noise)
    torch.cuda.synchronize()
    assert counts["ar_decode"] == 1
    want = sample_tokens(model, label, audio, noise=noise)
    assert torch.equal(tok.cpu(), want.cpu())
    tf, lg = sample_tokens_fused(model, label, audio, tables=tables, noise=noise,
                                 prefix_tokens=given, prefix_len=H, return_logits=True)
    _, want_lg = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                               prefix_len=H, return_logits=True)
    assert torch.equal(tf.cpu(), given.cpu())
    np.testing.assert_allclose(lg.cpu().numpy(), want_lg.cpu().numpy(), atol=1e-3)
    plan = ar_decode.launch_plan(shape[3], model.n_layers, model.dim, model.input_dim,
                                 model.out_hidden.out_features, 4)
    assert {k: ar_decode.last_launch[k] for k in ("smem_bytes", "ring_stages")} == \
        {k: plan[k] for k in ("smem_bytes", "ring_stages")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(256, 15, 2048, 17, 75)])
def test_bf16_tables_match_rounded_plain(cuda, shape):
    model, label, audio, given, noise = _case(*shape, cuda, seed=1)
    H = shape[4]
    tables = pack_decode_tables(model, torch.bfloat16)
    rounded = round_like_tables(model, torch.bfloat16)
    _, lg = sample_tokens_fused(model, label, audio, tables=tables, noise=noise,
                                prefix_tokens=given, prefix_len=H, return_logits=True)
    _, want = sample_tokens(rounded, label, audio, noise=noise, prefix_tokens=given,
                            prefix_len=H, return_logits=True)
    scale = want.abs().max().item()
    assert (lg - want).abs().max().item() <= 1e-3 * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 17])
def test_ragged_batch_and_partial_prefix_match_plain(cuda, B):
    """B = 3 and 17 leave lanes of the chain's dot products without a batch
    row; a prefix of 30 of 75 rows switches from teacher forcing to
    sampling inside the decode."""
    dim, layers, K, _, H = SHAPES[1]
    model, label, audio, given, noise = _case(dim, layers, K, B, H, cuda, seed=3)
    tables = pack_decode_tables(model, torch.float32)
    tok, lg = sample_tokens_fused(model, label, audio, tables=tables, noise=noise,
                                  prefix_tokens=given, prefix_len=30, return_logits=True)
    want, want_lg = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                                  prefix_len=30, return_logits=True)
    assert torch.equal(tok[:, :30].cpu(), given[:, :30].cpu())
    assert torch.equal(tok.cpu(), want.cpu())
    np.testing.assert_allclose(lg.cpu().numpy(), want_lg.cpu().numpy(), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_philox_reruns_are_bit_equal(cuda, B):
    """Ten reruns with one Philox seed: the roles meet only through flags, so
    a missing wait would show as a rerun that differs."""
    dim, layers, K, _, H = SHAPES[1]
    model, label, audio, _, _ = _case(dim, layers, K, B, H, cuda, seed=4)
    tables = pack_decode_tables(model)
    runs = [sample_tokens_fused(model, label, audio, tables=tables, return_logits=True,
                                generator=torch.Generator().manual_seed(7)) for _ in range(10)]
    for tok, lg in runs[1:]:
        assert torch.equal(tok, runs[0][0]) and torch.equal(lg, runs[0][1])


@pytest.mark.cuda
def test_philox_noise_is_seeded_and_in_range(cuda):
    model, label, audio, _, _ = _case(*SHAPES[0], cuda, seed=2)
    tables = pack_decode_tables(model)

    def run(seed):
        return sample_tokens_fused(model, label, audio, tables=tables,
                                   generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < SHAPES[0][2]


#: the 6-D variant's prior (dim 512, 10 layers over 2048 codes,
#: scripts/train.py:143-145), one 10 s clip's 75 token rows
SHAPE_6D = (512, 10, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 32])
def test_k1_at_the_6d_prior(cuda, B):
    """K1 at dim 512 x 10 layers: where the batch fits one launch (B <= 23
    there), f32 tables give the plain sampler's tokens under the same noise
    and its teacher-forced logits within 1e-3, bf16 tables the rounded plain
    version's logits within 1e-3 of max|logit|, and the launch takes the
    shared-memory carve `launch_plan` computes; where it does not (B = 32),
    the wrapper raises before any launch and names the largest batch."""
    model, label, audio, given, noise = _case(*SHAPE_6D, B, 75, cuda, seed=6)
    tables = pack_decode_tables(model, torch.float32)
    fits = ar_decode.model_max_batch(model, torch.float32)
    assert fits == 23
    counts.clear()
    if B > fits:
        with pytest.raises(ValueError, match=f"largest batch that fits is {fits}"):
            sample_tokens_fused(model, label, audio, tables=tables, noise=noise)
        assert counts["ar_decode"] == 0
        return
    tok = sample_tokens_fused(model, label, audio, tables=tables, noise=noise)
    torch.cuda.synchronize()
    assert counts["ar_decode"] == 1
    plan = ar_decode.launch_plan(B, model.n_layers, model.dim, model.input_dim,
                                 model.out_hidden.out_features, 4)
    assert ar_decode.last_launch["smem_bytes"] == plan["smem_bytes"]
    assert ar_decode.last_launch["ring_stages"] == plan["ring_stages"]
    assert torch.equal(tok.cpu(), sample_tokens(model, label, audio, noise=noise).cpu())
    _, lg = sample_tokens_fused(model, label, audio, tables=tables, noise=noise,
                                prefix_tokens=given, prefix_len=75, return_logits=True)
    _, want = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                            prefix_len=75, return_logits=True)
    np.testing.assert_allclose(lg.cpu().numpy(), want.cpu().numpy(), atol=1e-3)
    t16 = pack_decode_tables(model, torch.bfloat16)
    _, lg16 = sample_tokens_fused(model, label, audio, tables=t16, noise=noise,
                                  prefix_tokens=given, prefix_len=75, return_logits=True)
    _, want16 = sample_tokens(round_like_tables(model, torch.bfloat16), label, audio,
                              noise=noise, prefix_tokens=given, prefix_len=75,
                              return_logits=True)
    assert (lg16 - want16).abs().max().item() <= 1e-3 * max(want16.abs().max().item(), 1.0)


W2V_SHAPES = {  # name: (config, B, T frames, N samples)
    "tiny": (dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                  conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2)),
             3, 37, 3001),
    "full": ({}, 2, 300, 160000),
    # StreamingSession's windows at chunk_rows=8, context_rows=16: 32, 64
    # and 96 frames of ceil(frames * 16000 / 30) samples, B = 1
    "stream32": ({}, 1, 32, 17067),
    "stream64": ({}, 1, 64, 34134),
    "stream96": ({}, 1, 96, 51200),
}


def _w2v_case(name, device, seed=0):
    """A Wav2Vec2Encoder with random weights, biases and LayerNorm/GroupNorm
    parameters, plus hidden states (B, T, H) and a waveform (B, N)."""
    cfg, B, T, N = W2V_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    enc = init_weights_(Wav2Vec2Encoder(Wav2Vec2Config(**cfg)), gen)
    with torch.no_grad():
        for pname, p in enc.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn((B, T, enc.cfg.hidden_size), generator=gen)
    t = torch.arange(N) / 16000.0
    wave = 0.3 * torch.sin(2 * np.pi * 220.0 * t) + 0.05 * torch.randn((B, N), generator=gen)
    return enc.to(device).eval(), x.to(device), wave.to(device)


def _w2v_check(out, want, valid, dtype):
    for b, n in enumerate(valid):
        err = (out[b, :n] - want[b, :n]).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-3, err
        else:
            assert err <= 1e-2 * want[b, :n].abs().max().item(), err
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(W2V_SHAPES))
def test_encoder_layers_kernel_matches_plain(cuda, name, dtype, masked):
    enc, x, _ = _w2v_case(name, cuda)
    B, T = x.shape[:2]
    valid = [T - 7 * b * (T // 20) for b in range(B)] if masked else [T] * B
    vf = torch.tensor(valid, dtype=torch.int32) if masked else None
    tables = k2.pack_encoder_tables(enc, dtype)
    counts.clear()
    out = k2.encoder_layers_kernel(tables, x, vf)
    torch.cuda.synchronize()
    assert counts["wav2vec_layers"] == 1
    _w2v_check(out, k2.encoder_layers_plain(tables, x, vf), valid, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(W2V_SHAPES))
def test_extractor_kernel_matches_plain(cuda, name, dtype):
    enc, _, wave = _w2v_case(name, cuda, seed=1)
    tables = k3.pack_extractor_tables(enc.feature_extractor, dtype)
    counts.clear()
    out = k3.extractor_kernel(tables, wave)
    torch.cuda.synchronize()
    assert counts["wav2vec_extractor"] == 1
    want = k3.extractor_plain(tables, wave)
    assert out.shape == want.shape == (wave.shape[0], k3.out_length(wave.shape[1], tables),
                                       enc.cfg.conv_dim[-1])
    _w2v_check(out, want, [out.shape[1]] * out.shape[0], dtype)
    again = k3.extractor_kernel(tables, wave)
    assert torch.equal(out, again)     # fixed-order GroupNorm reduction: bit-for-bit


def _conv_gemm(B, T_in, k, s, cin, cout):
    """(M, N, K, lda, a_batch, Z) of a stride-s conv over channels-last rows."""
    return ((T_in - k) // s + 1, cout, k * cin, s * cin, T_in * cin, B)


GEMM_SHAPES = {  # name: (M, N, K, lda, a_batch, Z)
    **{f"k2_{n}_M{M}": (M, N, K, K, 0, 1)
       for M in (300, 2400)
       for n, N, K in (("qkv", 2304, 768), ("wo", 768, 768), ("w1", 3072, 768),
                       ("w2", 768, 3072))},
    **{f"k3_layer{i + 1}_B2": _conv_gemm(2, T_in, k, 2, 512, 512)
       for i, (T_in, k) in enumerate(((31999, 3), (15999, 3), (7999, 3), (3999, 3),
                                      (1999, 2), (999, 2)))},
    "tiny_conv_k3": _conv_gemm(3, 599, 3, 2, 32, 64)[:1] + (64, 96, 64, 599 * 32, 3),
    "tiny_conv_k2": _conv_gemm(3, 149, 2, 2, 32, 32),
    "tiny_qkv": (111, 192, 64, 64, 0, 1),
    "M1": (1, 768, 768, 768, 0, 1),
    "M77_ragged": (77, 136, 200, 200, 0, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3], ids=["unsplit", "split3"])
@pytest.mark.parametrize("name", list(GEMM_SHAPES))
def test_gemm_matches_matmul(cuda, name, splits):
    M, N, K, lda, a_batch, Z = GEMM_SHAPES[name]
    gen = torch.Generator().manual_seed(M + N + K)
    a = torch.randn((Z - 1) * a_batch + (M - 1) * lda + K, generator=gen).to(cuda, torch.bfloat16)
    w = torch.randn((N, K), generator=gen).to(cuda, torch.bfloat16)
    c = k2.gemm_kernel(a, w, M, lda, a_batch, Z, splits=splits)
    torch.cuda.synchronize()
    A = a.as_strided((Z, M, K), (a_batch, lda, 1)).float()
    want = A @ w.float().T
    assert c.shape == want.shape
    assert (c - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    if splits > 1:
        assert torch.equal(c, k2.gemm_kernel(a, w, M, lda, a_batch, Z, splits=splits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encoder_layers_kernel_padded_head_dim(cuda, dtype):
    """hd = 40 is padded to 48 in the attention's tiles (its K and V boxes
    carry the next head's columns there), and 3H = 240, H = 80 leave ragged
    GEMM tiles in N and K."""
    cfg = Wav2Vec2Config(hidden_size=80, num_layers=2, num_heads=2, intermediate_size=160)
    gen = torch.Generator().manual_seed(12)
    enc = init_weights_(Wav2Vec2Encoder(cfg), gen)
    x = torch.randn((2, 37, 80), generator=gen).to(cuda)
    tables = k2.pack_encoder_tables(enc.to(cuda).eval(), dtype)
    vf = torch.tensor([37, 20], dtype=torch.int32)
    _w2v_check(k2.encoder_layers_kernel(tables, x, vf), k2.encoder_layers_plain(tables, x, vf),
               [37, 20], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_encoder_layers_kernel_long_clip(cuda, dtype):
    """T = 3000 frames (100 s), one layer of hd = 64: the tensor-core
    attention stages K and V in tiles, so no clip length is too long for it."""
    cfg = Wav2Vec2Config(hidden_size=128, num_layers=1, num_heads=2, intermediate_size=256)
    gen = torch.Generator().manual_seed(11)
    enc = init_weights_(Wav2Vec2Encoder(cfg), gen)
    x = torch.randn((1, 3000, 128), generator=gen).to(cuda)
    tables = k2.pack_encoder_tables(enc.to(cuda).eval(), dtype)
    vf = torch.tensor([2900], dtype=torch.int32)
    _w2v_check(k2.encoder_layers_kernel(tables, x, vf), k2.encoder_layers_plain(tables, x, vf),
               [2900], dtype)


@pytest.mark.cuda
def test_encoder_layers_kernel_reruns_are_bit_equal(cuda):
    """Split-K sums its partial tiles in split order, never with float atomics."""
    enc, x, _ = _w2v_case("full", cuda, seed=2)
    tables = k2.pack_encoder_tables(enc, torch.bfloat16)
    vf = torch.tensor([300, 211], dtype=torch.int32)
    out = k2.encoder_layers_kernel(tables, x, vf)
    assert torch.equal(out, k2.encoder_layers_kernel(tables, x, vf))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D", [(37, 100, 16), (75, 2048, 64), (2816, 2048, 64),
                                   (1, 2048, 64), (11264, 2048, 64), (75, 2047, 64),
                                   (2816, 2047, 64), (300, 2048, 16), (300, 2048, 39),
                                   (75, 5000, 64), (2816, 5000, 39)])
def test_nearest_code_kernel_matches_plain(cuda, N, K, D):
    """Shapes of both tile variants, a ragged last slice (K = 2047), depths
    that are not a multiple of 4 or 8, and a codebook held in several
    passes (K = 5000).  Codes K-3..K-1 duplicate codes 0..2, whose slices
    lie in other CTAs of the cluster: the lower index must win across them."""
    gen = torch.Generator().manual_seed(N)
    emb = (torch.rand((K, D), generator=gen) * 2 - 1) * 0.05
    emb[K - 3:] = emb[:3]                      # duplicated codes: exact ties
    x = 0.05 * torch.randn((N, D), generator=gen)
    n3 = min(N, 3)
    x[:n3] = emb[:n3]
    x, emb = x.to(cuda), emb.to(cuda)
    plan = search_plan(N, K, D, torch.cuda.get_device_properties(cuda).multi_processor_count)
    if plan.cluster > 1:
        assert (K - 3) // plan.slice != 0      # the twins sit in another CTA's slice
    counts.clear()
    idx = vq_ops.nearest_code(x, emb)
    torch.cuda.synchronize()
    assert counts["nearest_code"] == 1 and counts["nearest_code_plain"] == 0
    assert idx.dtype == torch.int64 and idx.shape == (N,)
    assert torch.equal(idx, vq_ops.nearest_code(x, emb))   # reruns bit-equal
    assert idx[:n3].tolist() == list(range(n3))   # the lower index wins a tie
    e2 = (emb * emb).sum(1)
    dist = -2.0 * (x @ emb.T) + e2[None]
    top2 = dist.topk(2, dim=1, largest=False).values
    tol = 1e-5 * (1 + top2[:, 0].abs())
    assert bool((dist.gather(1, idx[:, None])[:, 0] - top2[:, 0] <= tol).all())
    near = top2[:, 1] - top2[:, 0] <= tol
    assert not bool(((idx != nearest_code_plain(x, emb, e2)) & ~near).any())


@pytest.mark.cuda
def test_nearest_code_kernel_unaligned_rows(cuda):
    """Rows whose base is not 16-byte aligned (a view at an odd offset) are
    searched through an aligned copy, with the same indices."""
    gen = torch.Generator().manual_seed(5)
    emb = ((torch.rand((2048, 64), generator=gen) * 2 - 1) * 0.05).to(cuda)
    x = (0.05 * torch.randn(75 * 64 + 1, generator=gen)).to(cuda)[1:].view(75, 64)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(nearest_code_kernel(x, emb), nearest_code_kernel(x.clone(), emb))


@pytest.mark.cuda
def test_nearest_code_kernel_raises_without_fallback(cuda):
    """D > 64 and non-contiguous rows raise; nothing falls back to the plain
    version."""
    emb = torch.zeros((16, 64), device=cuda)
    counts.clear()
    with pytest.raises(ValueError):
        nearest_code_kernel(torch.zeros((4, 65), device=cuda), torch.zeros((16, 65), device=cuda))
    with pytest.raises(ValueError):
        nearest_code_kernel(torch.zeros((64, 4), device=cuda).T, emb)
    with pytest.raises(ValueError):
        nearest_code_kernel(torch.zeros((4, 64), device=cuda), torch.zeros((64, 16), device=cuda).T)
    assert counts["nearest_code"] == 0 and counts["nearest_code_plain"] == 0


@pytest.mark.cuda
def test_served_flush_on_the_card(cuda, monkeypatch):
    """MotionServer at toy widths: per group one K1 launch at B = max_batch
    and one K2 launch (the masked face stage runs the plain masked
    extractor), never the plain sampler or the plain face stage; the
    served motion equals the CPU server's within 1e-3."""
    from talkshow_torch.models import body as body_mod
    from talkshow_torch.pipeline import Pipeline
    from talkshow_torch.serving import MotionServer
    cfg = Wav2Vec2Config(**W2V_SHAPES["tiny"][0])
    kw = dict(num_hiddens=64, pixel_dim=16, pixel_layers=3, code_num=32)
    gpu = Pipeline.create(3, cuda, cfg, **kw).with_face_dtype(torch.float32)
    gpu.table_dtype = torch.float32
    cpu = Pipeline.create(3, "cpu", cfg, **kw)
    gen, blocks = torch.Generator().manual_seed(0), {}

    def noise(*key):
        if key not in blocks:
            u = torch.rand((key[-1], 2, 4, 32), generator=gen).clamp_min(1e-30)
            blocks[key] = -torch.log(-torch.log(u))
        return blocks[key]

    batches = []
    fused = body_mod.sample_tokens_fused

    def spy(model, label, audio, **k):
        batches.append(audio.shape[0])
        return fused(model, label, audio, **k)

    monkeypatch.setattr(body_mod, "sample_tokens_fused", spy)
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(int(16000 * sec)) * 0.1).astype(np.float32)
            for sec in (0.5, 0.9, 0.4, 1.0, 0.3)]             # buckets 16, 32, 16, 32, 16
    out = {}
    for name, pipe in (("gpu", gpu), ("cpu", cpu)):
        server = MotionServer(pipe, bucket_frames=16, max_batch=4, noise=noise)
        rids = [server.submit(w, speaker=i % 4) for i, w in enumerate(wavs)]
        counts.clear()
        batches.clear()
        res = server.flush(seed=1)
        out[name] = ([res[r] for r in rids], dict(counts), list(batches))
    seen = out["gpu"][1]
    assert out["gpu"][2] == [4, 4]
    assert seen.get("ar_decode") == 2 and seen.get("wav2vec_layers") == 2
    assert seen.get("extractor_plain") == 2
    assert not seen.get("sample_tokens_plain") and not seen.get("face_plain")
    for g, c in zip(out["gpu"][0], out["cpu"][0]):
        assert g.shape == c.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, c, atol=1e-3)


@pytest.mark.cuda
def test_face_step_runs_k3_under_no_grad(cuda):
    """The face step's frozen extractor on the card (toy widths): one K3
    launch a whole-clip step on f32 tables, the plain extractor never, no
    autograd through it (no .grad on its parameters, which stay as they
    were); the step equals the same step on the CPU (stochastic=False):
    losses within 1e-4 relative, parameters within 1e-5 of max|p|."""
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.train.steps import make_face_step
    cfg = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                         conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    gen = torch.Generator().manual_seed(5)
    ids = torch.zeros((1, 4))
    ids[0, 1] = 1.0
    batch = {"waveform": torch.randn((1, 16000), generator=gen), "id_onehot": ids,
             "gt": 0.3 * torch.randn((1, 30, 265), generator=gen)}
    out = {}
    for dev in ("cpu", cuda):
        init, step = make_face_step(FaceGenerator(cfg), stochastic=False)
        state = init(torch.Generator().manual_seed(0), dev)
        before = {k: v.clone() for k, v in
                  state.face.audio_encoder.feature_extractor.state_dict().items()}
        counts.clear()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        out[str(dev)] = (dict(counts), m, state)
        ext = state.face.audio_encoder.feature_extractor
        assert all(p.grad is None and not p.requires_grad for p in ext.parameters())
        assert all(torch.equal(v, before[k]) for k, v in ext.state_dict().items())
    seen, mg, sg = out["cuda"]
    assert seen.get("wav2vec_extractor") == 1 and not seen.get("extractor_plain")
    assert sg.tables["w0"].dtype == torch.float32
    _, mc, sc = out["cpu"]
    for k in ("loss", "MSELoss", "exp_loss", "grad"):
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k])), k
    pc, pg = sc.face.state_dict(), sg.face.state_dict()
    top = max(v.abs().max().item() for v in pc.values())
    assert max((pg[k].cpu() - v).abs().max().item() for k, v in pc.items()) <= 1e-5 * top


TOY_W2V = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wav2vec_vq_encoder_routes_k3_and_k2(cuda, dtype):
    """Wav2VecVQEncoder's eval forward on the card (toy widths): one K3 and
    one K2 launch, no plain extractor or layer stack; its output against the
    plain forward of the same weights on the CPU within 1e-3 of max|out|
    on f32 tables and 1e-2 on bf16 ones (K2's and K3's tolerances)."""
    from talkshow_torch.models.vqvae import Wav2VecVQEncoder
    enc = init_weights_(Wav2VecVQEncoder(num_hiddens=32, wav2vec_cfg=Wav2Vec2Config(**TOY_W2V)),
                        torch.Generator().manual_seed(3)).eval()
    wave = 0.1 * torch.randn((2, 16000), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = enc(wave, 28)
        gpu = enc.to(cuda)
        tables = gpu.pack_tables(dtype)
        counts.clear()
        got = gpu(wave.to(cuda), 28, tables=tables)
        torch.cuda.synchronize()
    assert counts["wav2vec_extractor"] == 1 and counts["wav2vec_layers"] == 1
    assert not counts["extractor_plain"] and not counts["encoder_layers_plain"]
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    assert got.shape == want.shape == (2, 7, 32)
    assert (got.cpu() - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
def test_bf16_face_step_runs_k3_on_bf16_tables(cuda):
    """The --bf16 face step on the card (toy widths): its frozen extractor
    is one K3 launch on bf16 tables, within 1e-2 of max|out| of K3's plain
    version on the same tables (phase 7's bf16 tolerance); the step is
    finite and its losses within 2e-2 relative of the CPU's bf16 step
    (cuBLAS and the CPU round their bf16 products differently)."""
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.wav2vec_fused import frozen_features
    from talkshow_torch.train.steps import make_face_step
    cfg = Wav2Vec2Config(**TOY_W2V, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    ids = torch.zeros((1, 4))
    ids[0, 1] = 1.0
    batch = {"waveform": torch.randn((1, 16000), generator=gen), "id_onehot": ids,
             "gt": 0.3 * torch.randn((1, 30, 265), generator=gen)}
    out = {}
    for dev in ("cpu", cuda):
        init, step = make_face_step(FaceGenerator(cfg), stochastic=False)
        state = init(torch.Generator().manual_seed(0), dev)
        counts.clear()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        out[str(dev)] = (dict(counts), m, state)
    seen, mg, sg = out["cuda"]
    assert sg.tables["w0"].dtype == torch.bfloat16
    assert seen.get("wav2vec_extractor") == 1 and not seen.get("extractor_plain")
    _, mc, sc = out["cpu"]
    for k in ("loss", "MSELoss", "exp_loss"):
        assert np.isfinite(float(mg[k]))
        assert abs(float(mg[k]) - float(mc[k])) <= 2e-2 * abs(float(mc[k])), k
    enc = sg.face.audio_encoder
    got = frozen_features(enc, batch["waveform"].to(cuda), tables=sg.tables).cpu()
    want = k3.extractor_plain({k: v.cpu() if torch.is_tensor(v) else v
                               for k, v in sg.tables.items()}, batch["waveform"])
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_eval_body_decodes_on_k1_at_two_samples(cuda, monkeypatch):
    """eval/runners.eval_body at full width (prior 256 x 15 over 2048 codes,
    VQ-VAEs of 1024 hidden) on one 10 s clip: K1 once at B = 2, H = 75 on
    f32 tables, never the plain sampler; its tokens equal the plain
    sampler's on the card under the same noise."""
    from talkshow_torch.data.dataset import synthetic_dataset
    from talkshow_torch.eval import runners
    from talkshow_torch.models.vqvae import AE
    from talkshow_torch.pipeline import Pipeline
    pipe = Pipeline.create(2, cuda)
    pipe.table_dtype = torch.float32
    body = pipe.body
    ae = init_weights_(AE(129, 64, 64), torch.Generator().manual_seed(3)).to(cuda)
    ds = synthetic_dataset(num_clips=1, frames=300)
    ds.clips[0].poses = ds.clips[0].poses[:300]
    ds.clips[0].aud_feat = ds.clips[0].aud_feat[:300]
    noise = -torch.log(-torch.log(torch.rand((75, 2, 2, 2048), generator=torch.Generator()
                                             .manual_seed(4)).clamp_min(1e-30)))
    seen = []
    real = runners.generate_conv_poses

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((a[1], a[2], out[1]))
        return out

    monkeypatch.setattr(runners, "generate_conv_poses", spy)
    counts.clear()
    res = runners.eval_body(pipe, ae, ds, num_samples=2, noise=lambda ci: noise)
    torch.cuda.synchronize()
    assert counts["ar_decode"] == 1 and not counts["sample_tokens_plain"]
    assert np.isfinite(res["fgd"]) and np.isfinite(res["l2"])
    feat, ids, tok = seen[0]
    assert tok.shape == (2, 75, 2)
    with torch.no_grad():
        want = sample_tokens(body.prior, ids, body.audio_enc(feat), noise=noise.to(cuda))
    assert torch.equal(tok, want)


@pytest.mark.cuda
def test_eval_vq_capacity_searches_on_k4_at_75_rows(cuda):
    """eval/runners.eval_vq_capacity at full width (1024 hidden, 2048 x 64
    codebooks) on one 10 s clip: K4 twice (N = 75 per quantizer), never the
    plain search; the capacity within 1e-4 relative of the same models on
    the CPU (a near-tie pick can only move it by the tie's gap)."""
    from talkshow_torch.data.dataset import synthetic_dataset
    from talkshow_torch.eval import runners
    from talkshow_torch.models.vqvae import VQVAE
    gen = torch.Generator().manual_seed(5)
    models = {k: init_weights_(VQVAE(w), gen) for k, w in (("body", 39), ("hand", 90))}
    states = {k: vq_ops.init_vq_state(gen, 2048, 64, "cpu") for k in models}
    ds = synthetic_dataset(num_clips=1, frames=300)
    ds.clips[0].poses = ds.clips[0].poses[:300]
    want = runners.eval_vq_capacity(models["body"], models["hand"], states, ds)
    for m in models.values():
        m.to(cuda)
    counts.clear()
    got = runners.eval_vq_capacity(models["body"], models["hand"],
                                   {k: s.to(cuda) for k, s in states.items()}, ds)
    torch.cuda.synchronize()
    assert counts["nearest_code"] == 2 and not counts["nearest_code_plain"]
    assert abs(got["capacity_l1"] - want["capacity_l1"]) <= 1e-4 * want["capacity_l1"]


def test_kernels_raise_on_cpu_tensors():
    enc, x, wave = _w2v_case("tiny", "cpu")
    with pytest.raises(ValueError):
        k2.encoder_layers_kernel(k2.pack_encoder_tables(enc), x)
    with pytest.raises(ValueError):
        k3.extractor_kernel(k3.pack_extractor_tables(enc.feature_extractor), wave)
    with pytest.raises(ValueError):
        k2.gemm_kernel(torch.zeros(64, dtype=torch.bfloat16), torch.zeros((8, 8), dtype=torch.bfloat16),
                       1, 8)

"""WavLM's modes of the wav2vec kernels against their plain twins, on an
NVIDIA GPU, at WavLM Large's published widths (24 x 1024, 16 heads, FFN
4096, 320 buckets to distance 800; seven 512-wide convs): K2's pre-norm
mode with the gated relative bias and K3's LayerNorm mode, at T = 150 and
900 frames (5 s and 30 s clips), unmasked and masked; then the WavLM face
through `Pipeline.generate_face` and a `MotionServer` flush on the card.
Every test skips where CUDA is absent: the kernels have no CPU mode.

    python -m pytest --noconftest tests/test_torch_wavlm_cuda.py -q

Tolerances: the kernel and its plain twin round the operands of every
product to the table type on both sides, so they differ in summation
order, and (bf16) where an intermediate rounded to bf16 on one side rounds
the other way on the other: f32 tables within 1e-3, bf16 tables within
2e-2 of the output's largest magnitude (24 pre-norm layers carry such a
one-ulp difference, 2**-8 of a value, down the residual stream; the
post-norm base's is 1e-2 over 12).  The gate is computed in f32 on both
sides from the same LayerNorm output.  The face on the card (bf16 tables)
against the plain f32 face stage: ||d|| / ||ref|| within 0.05, the
benchmark's limit for this configuration's cell is set from chip readings.
"""
import numpy as np
import pytest
import torch

from talkshow_torch.kernels import counts
from talkshow_torch.kernels import wav2vec_extractor as k3
from talkshow_torch.kernels import wav2vec_layers as k2
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder

WAVLM_LARGE = dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
                   do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=False,
                   num_buckets=320, max_bucket_distance=800)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoder(device, seed=0, **extra):
    gen = torch.Generator().manual_seed(seed)
    enc = init_weights_(Wav2Vec2Encoder(Wav2Vec2Config(**{**WAVLM_LARGE, **extra})), gen)
    with torch.no_grad():
        for _, p in enc.named_parameters():
            if p.dim() == 1 or p.shape[0] == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return enc.to(device).eval()


def _check(out, want, valid, dtype):
    for b, n in enumerate(valid):
        err = (out[b, :n] - want[b, :n]).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-3, err
        else:
            assert err <= 2e-2 * want[b, :n].abs().max().item(), err
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("T", [150, 900])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_prenorm_layers_match_plain(cuda, dtype, T, masked):
    enc = _encoder(cuda)
    B = 2
    x = torch.randn((B, T, 1024), generator=torch.Generator().manual_seed(T)).to(cuda)
    valid = [T, T - T // 3] if masked else [T] * B
    vf = torch.tensor(valid, dtype=torch.int32) if masked else None
    tables = k2.pack_encoder_tables(enc, dtype)
    assert tables["prenorm"] and tables["relb"].shape == (16, 1601)
    counts.clear()
    out = k2.encoder_layers_kernel(tables, x, vf)
    torch.cuda.synchronize()
    assert counts["wav2vec_layers"] == counts["w2v_layers_prenorm"] == 1
    _check(out, k2.encoder_layers_plain(tables, x, vf), valid, dtype)
    if dtype == torch.bfloat16 and not masked:
        assert torch.equal(out, k2.encoder_layers_kernel(tables, x, vf))   # reruns bit-equal


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [5, 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layernorm_extractor_matches_plain(cuda, dtype, seconds):
    enc = _encoder(cuda, seed=1)
    N = 16000 * seconds
    t = torch.arange(N) / 16000.0
    gen = torch.Generator().manual_seed(seconds)
    wave = (0.3 * torch.sin(2 * np.pi * 220.0 * t)
            + 0.05 * torch.randn((2, N), generator=gen)).to(cuda)
    tables = k3.pack_extractor_tables(enc.feature_extractor, dtype)
    assert "ln" in tables and "gn" not in tables
    counts.clear()
    out = k3.extractor_kernel(tables, wave)
    torch.cuda.synchronize()
    assert counts["wav2vec_extractor"] == counts["extractor_layernorm"] == 1
    want = k3.extractor_plain(tables, wave)
    assert out.shape == want.shape == (2, k3.out_length(N, tables), 512)
    _check(out, want, [out.shape[1]] * 2, dtype)
    assert torch.equal(out, k3.extractor_kernel(tables, wave))   # fixed-order sums


@pytest.mark.cuda
def test_wavlm_face_through_the_pipeline_and_server(cuda):
    from talkshow_torch.pipeline import Pipeline
    from talkshow_torch.serving import MotionServer
    pipe = Pipeline.create(seed=3, device="cuda", wav2vec_cfg=Wav2Vec2Config(**WAVLM_LARGE))
    gen = torch.Generator().manual_seed(4)
    wav = (0.3 * torch.randn(16000 * 7, generator=gen)).numpy()
    counts.clear()
    face = pipe.generate_face(wav)
    torch.cuda.synchronize()
    assert face.shape == (210, 103)
    assert counts["w2v_layers_prenorm"] == counts["extractor_layernorm"] == 1
    assert counts["extractor_plain"] == counts["encoder_layers_plain"] == counts["face_plain"] == 0
    with torch.no_grad():
        want = pipe.face_model(torch.as_tensor(wav, device=cuda)[None],
                               torch.zeros(1, 4, device=cuda), 210)[0].cpu().numpy()
    assert np.linalg.norm(face - want) / np.linalg.norm(want) < 0.05
    server = MotionServer(pipe, bucket_frames=32, max_batch=2, transfer_dtype="float32")
    counts.clear()
    rid = server.submit(wav)
    motion = server.flush(seed=1)[rid]
    torch.cuda.synchronize()
    assert motion.shape == (210, 265) and np.isfinite(motion).all()
    assert counts["w2v_layers_prenorm"] == counts["extractor_layernorm"] == 1
    assert counts["extractor_plain"] == 0
    # the masked face stage's real frames against the unpadded clip's
    jaw_exp = np.concatenate([motion[:, :3], motion[:, -100:]], axis=-1)
    assert np.linalg.norm(jaw_exp - face) / np.linalg.norm(face) < 1e-2

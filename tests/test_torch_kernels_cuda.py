"""Kernel K1 (talkshow_torch/csrc/ar_decode.cu) against its plain PyTorch
version, on an NVIDIA GPU.  Every test skips where CUDA is absent: the
kernel has no CPU mode.  Imports no JAX, so it runs on a machine with the
card and PyTorch only:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: f32 tables agree with the plain version to 1e-3 in the logits
(the same f32 math, summed in another order through 15 layers); bf16
tables are compared with the plain version fed the same bf16-rounded
weights, so only the summation order differs there too.
"""
import numpy as np
import pytest
import torch

from talkshow_torch.kernels import counts
from talkshow_torch.kernels.ar_decode import (pack_decode_tables, round_like_tables,
                                              sample_tokens_fused)
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.pixelcnn import GatedPixelCNN, sample_tokens

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
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
def test_philox_noise_is_seeded_and_in_range(cuda):
    model, label, audio, _, _ = _case(*SHAPES[0], cuda, seed=2)
    tables = pack_decode_tables(model)

    def run(seed):
        return sample_tokens_fused(model, label, audio, tables=tables,
                                   generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < SHAPES[0][2]

"""WavLM as the face stage's encoder, on the CPU at toy widths (hidden 64, 4
heads of 16, 2 pre-norm layers, the published 320 buckets to distance 800,
a LayerNorm conv extractor): the port against the plain float32 reference
`benchmark/reference/wavlm.py` on the benchmark's seeded weights, through
the plain modules, through both kernels' plain twins (`face_apply_fused`
on CPU tensors) and through `Pipeline.create(wav2vec_cfg=...)`; clips of up
to 1000 frames, so that exact (|d| < 80), log (80-799) and clamped (>= 800)
buckets all occur.

Tolerances: the port and the reference compute the same float32
mathematics in another order (the gate's two sums of 4 outputs as one
product with summed rows, F.layer_norm against its own statistics): within
1e-4 of ||ref|| (they read ~1e-6).  With bf16 tables the twins round every
product's operands to bf16 (2**-8 relative) as the card does: within 3e-2.
A gate held at 1, the bias dropped and the post-norm order each move the
output far past the f32 tolerance, and the fused twins past the bf16 one.
"""
import math

import numpy as np
import pytest
import torch

from benchmark import traffic, wavlm_weights
from benchmark.gen import read_wav
from benchmark.reference import nets
from benchmark.reference import wavlm as ref_wavlm
from talkshow_torch import convert
from talkshow_torch.kernels import wav2vec_layers as k2
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder, relative_buckets
from talkshow_torch.models.wav2vec_fused import face_apply_fused
from talkshow_torch.pipeline import Pipeline

W = {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "intermediate_size": 128,
     "conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
     "conv_stride": [5, 2, 2, 2, 2, 2, 2], "num_conv_pos_embeddings": 16,
     "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5, "do_stable_layer_norm": True,
     "feat_extract_norm": "layer", "conv_bias": False, "num_buckets": 320,
     "max_bucket_distance": 800}
FACE = {"num_classes": 4, "jaw_dim": 3, "exp_dim": 100, "feature_dim": 256}
CFG = {"wav2vec": W, "face": FACE}
F32_TOL, BF16_TOL = 1e-4, 3e-2
#: 1000 frames: the longest distance 999 lies past the clamp at 800
SAMPLES = 1000 * 16000 // 30 + 1


def _w2v_cfg(**over):
    return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in {**W, **over}.items()})


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    w = wavlm_weights.draw(CFG, 2 ** 40 + 5, "cpu")
    face = FaceGenerator(_w2v_cfg(), 4, 3, 100).eval()
    face.load_state_dict(w["face"])
    gen = torch.Generator().manual_seed(1)
    wav = 0.3 * torch.randn(SAMPLES, generator=gen)
    ref = ref_wavlm.Reference(CFG, w, "cpu")
    want = ref.face(wav)
    assert want.shape == (1000, 103)
    return w, face, wav, want


def _face(face, wav, **kw):
    with torch.no_grad():
        return face(wav[None], torch.zeros(1, 4), wav.shape[0] * 30 // 16000, **kw)[0]


def test_relative_buckets_against_a_loop():
    T = 1000
    got = relative_buckets(T, 320, 800)
    for d in range(-(T - 1), T):
        a, half, quarter = abs(d), 160, 80
        if a < quarter:
            want = a
        else:
            want = min(int(quarter + math.log(a / quarter) / math.log(800 / quarter)
                           * (half - quarter)), half - 1)
        want += half if d > 0 else 0
        i, j = (0, d) if d >= 0 else (-d, 0)
        assert got[i, j] == want, d
    assert torch.equal(got, ref_wavlm.buckets(T, 320, 800))
    assert {int(got[0, 1]), int(got[0, 100]), int(got[0, 999])} == {161, 247, 319}


def test_port_matches_reference(case):
    _, face, wav, want = case
    assert _rel(_face(face, wav), want) < F32_TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_plain_twins_match_reference(case, dtype, tol):
    _, face, wav, want = case
    out = face_apply_fused(face, wav[None], torch.zeros(1, 4), 1000, dtype=dtype)[0]
    assert _rel(out, want) < tol


def test_pipeline_generate_face_matches_reference(case, tmp_path):
    w, _, wav, want = case
    pipe = Pipeline.create(0, "cpu", _w2v_cfg(), code_num=64, embedding_dim=16, num_hiddens=32,
                           pixel_dim=32, pixel_layers=2)
    pipe.face_model.load_state_dict(w["face"])
    short = wav[:16000 * 4]
    out = pipe.generate_face(short.numpy())
    ref = ref_wavlm.Reference(CFG, w, "cpu").face(short)
    assert out.shape == (120, 103) and _rel(torch.as_tensor(out), ref) < F32_TOL
    # `generate` splices the same face stage's jaw and expression into its motion
    path = str(tmp_path / "clip.wav")
    traffic.write_wav(path, short.numpy())
    motion = pipe.generate(path, num_samples=1)[0]
    face = pipe.generate_face(read_wav(path))
    assert motion.shape == (120, 265)
    np.testing.assert_array_equal(np.concatenate([motion[:, :3], motion[:, -100:]], -1), face)


def _gate_one(self, x):
    B, T, _ = x.shape
    return torch.ones(B, self.heads, T)


@pytest.mark.parametrize("fault", ["gate_one", "bias_drop", "post_norm"])
def test_faults_fail_the_tolerance(case, monkeypatch, fault):
    from talkshow_torch.models import wav2vec
    w, face, wav, want = case
    if fault == "post_norm":
        face = FaceGenerator(_w2v_cfg(do_stable_layer_norm=False), 4, 3, 100).eval()
        face.load_state_dict(w["face"])
    elif fault == "gate_one":
        monkeypatch.setattr(wav2vec.Attention, "gate", _gate_one)
    else:
        monkeypatch.setattr(wav2vec.Wav2Vec2Encoder, "position_bias",
                            lambda self, T, device: torch.zeros(4, T, T))
    short = wav[:16000 * 12]
    ref = ref_wavlm.Reference(CFG, w, "cpu").face(short)
    assert _rel(_face(face, short), ref) > 10 * F32_TOL
    if fault != "post_norm":          # the twins read the same fault from their tables
        from benchmark import wavlm_faults
        undo = wavlm_faults.plant(fault)
        try:
            out = face_apply_fused(face, short[None], torch.zeros(1, 4), 360,
                                   dtype=torch.bfloat16)[0]
        finally:
            undo()
        assert _rel(out, ref) > BF16_TOL


def test_base_config_is_unchanged():
    """wav2vec 2.0 base: no WavLM module, no new table, and the post-norm
    output the base reference gives."""
    cfg = Wav2Vec2Config(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                         conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4)
    face = init_weights_(FaceGenerator(cfg), torch.Generator().manual_seed(2)).eval()
    names = list(face.state_dict())
    assert not any("gru_rel" in n or "rel_attn" in n for n in names)
    assert not any("conv_layers.1.layer_norm" in n for n in names)
    wb = {k: getattr(cfg, k) for k in ("hidden_size", "num_layers", "num_heads",
                                       "intermediate_size", "conv_dim", "conv_kernel",
                                       "conv_stride", "num_conv_pos_embeddings",
                                       "num_conv_pos_embedding_groups", "layer_norm_eps")}
    ref = nets.FaceGenerator(wb, FACE).eval()
    ref.load_state_dict(face.state_dict())
    wav = 0.3 * torch.randn(16000 * 2, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = ref(wav[None], torch.zeros(1, 4), 60)[0]
    assert _rel(_face(face, wav), want) < F32_TOL
    tables = k2.pack_encoder_tables(face.audio_encoder, torch.float32)
    assert "prenorm" not in tables
    out = face_apply_fused(face, wav[None], torch.zeros(1, 4), 60, dtype=torch.float32)[0]
    assert _rel(out, want) < F32_TOL


def test_config_from_hf_reads_wavlm_keys():
    hf = {"hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
          "intermediate_size": 4096, "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
          "conv_stride": [5, 2, 2, 2, 2, 2, 2], "num_conv_pos_embeddings": 128,
          "num_conv_pos_embedding_groups": 16}
    base = convert.config_from_hf(hf)
    assert (base.do_stable_layer_norm, base.feat_extract_norm, base.conv_bias,
            base.num_buckets, base.max_bucket_distance) == (False, "group", False, 0, 0)
    wavlm = convert.config_from_hf({**hf, "do_stable_layer_norm": True,
                                    "feat_extract_norm": "layer", "conv_bias": False,
                                    "num_buckets": 320, "max_bucket_distance": 800})
    assert (wavlm.do_stable_layer_norm, wavlm.feat_extract_norm, wavlm.num_buckets,
            wavlm.max_bucket_distance) == (True, "layer", 320, 800)
    with pytest.raises(ValueError, match="conv_bias"):
        convert.config_from_hf({**hf, "conv_bias": True})
    with pytest.raises(ValueError, match="conv_bias"):
        Wav2Vec2Encoder(_w2v_cfg(conv_bias=True))


def test_hf_wavlm_state_dict_maps_onto_the_port():
    """A synthetic Hugging Face WavLMModel state dict (weight-normed
    positional conv, `rel_attn_embed` on layer 0 only, every layer's gate,
    each conv's LayerNorm) loads strictly after `reference_wav2vec`."""
    ref = ref_wavlm.WavLM(W)
    sd = {k: torch.randn(v.shape) for k, v in ref.state_dict().items()}
    pos = "encoder.pos_conv_embed.conv"
    v = sd.pop(pos + ".weight")
    sd[pos + ".weight_v"] = v
    sd[pos + ".weight_g"] = v.norm(dim=(0, 1), keepdim=True)
    enc = Wav2Vec2Encoder(_w2v_cfg())
    enc.load_state_dict(convert.reference_wav2vec(sd))
    got = enc.state_dict()
    for key in ("encoder.layers.0.attention.rel_attn_embed.weight",
                "encoder.layers.1.attention.gru_rel_pos_const",
                "encoder.layers.1.attention.gru_rel_pos_linear.weight",
                "feature_extractor.conv_layers.6.layer_norm.bias"):
        assert torch.equal(got[key], sd[key]), key
    assert torch.allclose(got[pos + ".weight"], v, atol=1e-5)
    assert "encoder.layers.1.attention.rel_attn_embed.weight" not in got
    assert np.isfinite(enc(torch.randn(1, 16000), 30).detach().numpy()).all()


def test_prenorm_without_buckets_twins_match_the_module():
    """A stable-order encoder without relative buckets (wav2vec 2.0 large's
    layout, as `config_from_hf` reads it): the twins' zero bias table."""
    cfg = _w2v_cfg(num_buckets=0, max_bucket_distance=0)
    face = init_weights_(FaceGenerator(cfg), torch.Generator().manual_seed(4)).eval()
    assert not any("gru_rel" in n for n in face.state_dict())
    wav = 0.3 * torch.randn(16000 * 3, generator=torch.Generator().manual_seed(5))
    want = _face(face, wav)
    out = face_apply_fused(face, wav[None], torch.zeros(1, 4), 90, dtype=torch.float32)[0]
    assert _rel(out, want) < F32_TOL

"""The plain reference against talkshow_torch at toy widths on the CPU, on
the benchmark's own weights: each layer the check covers, then each entry
end to end through the harness (correct, with readings at float32's
rounding)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import gen, harness, traffic, weights
from benchmark.reference import audio as ref_audio
from benchmark.reference import model as ref_model
from benchmark.reference import pose as ref_pose
from benchmark.tests import toy


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    w = weights.draw(toy.TOY_CFG, 99, "cpu")
    pipe = gen.build_program(toy.TOY_CFG, w, "cpu")
    ref = ref_model.Reference(toy.TOY_CFG, w, "cpu")
    path = str(tmp_path_factory.mktemp("clip") / "clip.wav")
    traffic.write_wav(path, traffic.speech(1.5, np.random.default_rng(0)))
    return pipe, ref, path


def _close(a, b, tol):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape
    assert float((a - b).norm() / b.norm()) < tol


def test_mfcc(sides):
    from talkshow_torch.ops import audio
    _, _, path = sides
    wav = torch.as_tensor(gen.read_wav(path))
    _close(audio.get_mfcc(path, device="cpu"), ref_audio.get_mfcc(wav), 1e-5)


def test_face_stage(sides):
    pipe, ref, path = sides
    wav = gen.read_wav(path)
    _close(pipe.generate_face(wav), ref.face(torch.as_tensor(wav)), 1e-5)


def test_audio_encoder_logits_and_decoders(sides):
    from talkshow_torch.models.pixelcnn import sample_tokens
    pipe, ref, path = sides
    wav = torch.as_tensor(gen.read_wav(path))
    feat = ref_audio.get_mfcc(wav)
    aud = ref.audio_from_mfcc(feat)
    with torch.no_grad():
        _close(pipe.body.audio_enc(feat[None]), aud, 1e-5)
        S, H, K = 3, aud.shape[1], toy.TOY_CFG["prior"]["input_dim"]
        noise = gen.gumbel(5, H, S, K, "cpu")
        label = torch.full((S,), 2)
        tokens, logits = sample_tokens(pipe.body.prior, label, aud.expand(S, -1, -1),
                                       noise=noise, return_logits=True)
    _close(logits, ref.logits(tokens, 2, aud), 1e-5)
    with torch.no_grad():
        from talkshow_torch.models.body import generate_conv_poses
        conv, _ = generate_conv_poses(pipe.body, feat[None].expand(S, -1, -1), label,
                                      noise=noise)
    _close(conv, ref.decode(tokens), 1e-5)


def test_assembly(sides):
    pipe, _, _ = sides
    face = torch.randn(40, 103)
    conv = torch.randn(2, 36, 129)
    _close(pipe.assemble_full(face.numpy(), conv.numpy()), ref_pose.assemble(face, conv), 1e-7)
    groups = ref_pose.channel_groups()
    assert len(groups["face"]) == 103 and len(groups["body"]) == 129
    assert len(groups["fixed"]) == 33


@pytest.mark.parametrize("cell", ["toy-gen", "toy-body"])
def test_entry_end_to_end(toy_root, cell):
    out = harness.execute(toy.spec(toy_root, cell), 2 ** 33 + 5, 1.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"clip_ms_p95", "motion_s_per_s", "setup_s"}

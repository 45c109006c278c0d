"""The reference trainer's checkpoint files through the port's loader.

The golden fixtures (tests/fixtures/golden, written by
scripts/make_golden_fixtures.py from torch replicas of the reference
modules) hold the on-disk format: the Trainer nesting {'generator',
'epoch', 'global_steps'}, the optimizer entries, DataParallel's `module.`
prefixes, mask-A's zeroed kernel row and column and the weight-normed
positional conv.  The port's modules, loaded strictly through
`talkshow_torch.convert.reference_*`, reproduce the replicas' outputs in
expected.npz at the JAX test's tolerances
(tests/test_golden_ckpt_fixtures.py): VQ indices exact, reconstructions
and the audio encoder 2e-4, PixelCNN logits 3e-4, the face stage 5e-4."""
import json
import os
import wave

import numpy as np
import pytest
import torch

from talkshow_torch import convert
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.pixelcnn import GatedPixelCNN
from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
from talkshow_torch.pipeline import Pipeline

torch.set_num_threads(2)

HERE = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "meta.json")) as f:
        meta = json.load(f)
    return meta, dict(np.load(os.path.join(HERE, "expected.npz")))


def _load(name):
    return torch.load(os.path.join(HERE, name), map_location="cpu", weights_only=True)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_strip_module_prefix_and_trainer_nesting():
    ckpt = _load("body_pixel.pth")
    assert ckpt["epoch"] == 99 and len(ckpt["generator"]["generator_optim"]["state"]) > 0
    sd = ckpt["generator"]["generator"]
    assert all(k.startswith("module.") for k in sd)
    assert not any(k.startswith("module.") for k in convert.strip_module_prefix(sd))
    # the Trainer file and the bare wrapper state convert alike
    a = convert.reference_body_pixel(ckpt)
    b = convert.reference_body_pixel(ckpt["generator"])
    for part in ("prior", "audio_enc"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])


def test_body_vq_fixture(golden):
    meta, exp = golden
    ckpt = _load("body_vq.pth")
    assert ckpt["epoch"] == 99 and ckpt["global_steps"] == 12345
    assert len(ckpt["generator"]["g_body_optim"]["state"]) > 0
    out = convert.reference_body_vq(ckpt)
    for part, cin in (("body", BODY_DIM), ("hand", HAND_DIM)):
        model = VQVAE(cin, 64, meta["vq_hid"])
        model.load_state_dict(out[f"vq_{part}"])
        model.eval()
        state = out[f"vq_{part}_state"]
        assert int(state.counter) == 0 and state.ema_dw_hidden.shape == state.embeddings.shape
        with torch.no_grad():
            _, idx = model.encode(_t(exp[f"vq_in_{part}"]).transpose(1, 2), state)
            np.testing.assert_array_equal(idx.numpy(), exp[f"vq_idx_{part}"])
            rec = model.decode_latents(idx, state)
        np.testing.assert_allclose(rec.transpose(1, 2).numpy(), exp[f"vq_rec_{part}"],
                                   atol=2e-4)


def test_body_pixel_fixture(golden):
    meta, exp = golden
    px = meta["pixel"]
    out = convert.reference_body_pixel(_load("body_pixel.pth"))
    # mask-A's zeroed last row / column cropped, 1x1 convs as Linear
    assert out["prior"]["layers.0.vert_stack.weight"].shape[2] == 3
    assert out["prior"]["layers.0.horiz_stack.weight"].shape[3] == 1
    assert out["prior"]["fusion_v.weight"].dim() == 2
    aenc = AudioEncoder(64, num_hiddens=px["aud_ch"])
    aenc.load_state_dict(out["audio_enc"])
    prior = GatedPixelCNN(input_dim=px["K"], dim=px["dim"], n_layers=px["n_layers"],
                          n_classes=4, audio_channels=px["aud_ch"])
    prior.load_state_dict(out["prior"])
    with torch.no_grad():
        a = aenc.eval()(_t(exp["px_aud"]).transpose(1, 2))
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), exp["px_audenc"], atol=2e-4)
        lg = prior.eval()(_t(exp["px_tokens"]), _t(exp["px_label"]),
                          _t(exp["px_audenc"]).transpose(1, 2))
    np.testing.assert_allclose(lg.numpy(), exp["px_logits"], atol=3e-4)


def test_face_fixture(golden):
    meta, exp = golden
    ckpt = _load("face.pth")
    assert ckpt["generator"]["generator_optim"]["param_groups"]
    cfg = convert.config_from_hf(meta["hf_wav2vec"])
    assert cfg.num_layers == 2 and cfg.conv_stride == (5, 2, 2) and cfg.layer_norm_eps == 1e-5
    face = FaceGenerator(cfg)
    face.load_state_dict(convert.reference_face(ckpt))
    frames = exp["face_out"].shape[1]
    with torch.no_grad():
        out = face.eval()(_t(exp["face_wav"])[None], torch.zeros((1, 4)), frames)
    np.testing.assert_allclose(out.numpy(), exp["face_out"], atol=5e-4)


def test_from_torch_checkpoints_end_to_end(golden, tmp_path):
    """All three files into one CPU pipeline at the fixtures' widths: the
    face stage reproduces the replica's output, the body stage decodes the
    replica's codes, and generate() runs end to end."""
    meta, exp = golden
    px = meta["pixel"]
    pipe = Pipeline.from_torch_checkpoints(
        os.path.join(HERE, "face.pth"), os.path.join(HERE, "body_pixel.pth"),
        os.path.join(HERE, "body_vq.pth"), device="cpu",
        wav2vec_cfg=convert.config_from_hf(meta["hf_wav2vec"]), num_hiddens=meta["vq_hid"],
        code_num=px["K"], pixel_dim=px["dim"], pixel_layers=px["n_layers"],
        audio_channels=px["aud_ch"])
    face = pipe.generate_face(exp["face_wav"], frame=exp["face_out"].shape[1])
    np.testing.assert_allclose(face[None], exp["face_out"], atol=5e-4)
    with torch.no_grad():
        rec = pipe.body.vq_hand.decode_latents(_t(exp["vq_idx_hand"]), pipe.body.vq_hand_state)
    np.testing.assert_allclose(rec.transpose(1, 2).numpy(), exp["vq_rec_hand"], atol=2e-4)
    path = str(tmp_path / "speech.wav")
    x = 0.2 * np.sin(2 * np.pi * 200 * np.arange(16000) / 16000.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    motion = pipe.generate(path, num_samples=2, seed=1)
    assert motion.shape == (2, 30, 265) and np.isfinite(motion).all()

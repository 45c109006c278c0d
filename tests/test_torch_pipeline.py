"""The port's whole slice against the JAX package: Pipeline.generate on one
synthetic wav with the same weights and the same sampling noise gives the
same tokens and the same motion (atol 1e-4); importing the port pulls in no
JAX."""
import os
import subprocess
import sys
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models.body import BodyModels
from talkshow_tpu.models.face import FaceGenerator
from talkshow_tpu.models.pixelcnn import GatedPixelCNN
from talkshow_tpu.models.vqvae import VQVAE, AudioEncoder
from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
from talkshow_tpu.ops.pose import BODY_DIM, HAND_DIM
from talkshow_tpu.ops.vq import init_vq_state
from talkshow_tpu.pipeline import Pipeline as JPipeline
from talkshow_torch.convert import from_jax
from talkshow_torch.kernels import counts
from talkshow_torch.models.body import generate_conv_poses
from talkshow_torch.models.pixelcnn import sample_tokens
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops import audio as taudio
from talkshow_torch.pipeline import Pipeline

torch.set_num_threads(2)

TINY = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
BODY = dict(num_hiddens=64, pixel_dim=16, pixel_layers=3, code_num=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_pipeline(seed):
    """JPipeline.create(seed, wav2vec_cfg=TINY, **BODY) with every flax init
    under jit: the same random weights, without op-by-op dispatch (~20 s)."""
    r_face, r_body = jax.random.split(jax.random.PRNGKey(seed))
    face = FaceGenerator(wav2vec_cfg=JCfg(**TINY))
    face_vars = jax.jit(face.init, static_argnums=3)(
        r_face, jnp.zeros((1, 3200)), jnp.zeros((1, 4)), 6)
    r = jax.random.split(r_body, 6)
    vq_b = VQVAE(in_dim=BODY_DIM, embedding_dim=64, num_hiddens=BODY["num_hiddens"])
    vq_h = VQVAE(in_dim=HAND_DIM, embedding_dim=64, num_hiddens=BODY["num_hiddens"])
    st_b = init_vq_state(r[0], BODY["code_num"], 64)
    st_h = init_vq_state(r[1], BODY["code_num"], 64)
    audio_enc = AudioEncoder(num_hiddens=256)
    prior = GatedPixelCNN(input_dim=BODY["code_num"], dim=BODY["pixel_dim"],
                          n_layers=BODY["pixel_layers"], n_classes=4, audio=True,
                          bh_model=True)
    body = BodyModels(
        vq_b, vq_h,
        jax.jit(vq_b.init)(r[2], jnp.zeros((1, 88, BODY_DIM)), st_b),
        jax.jit(vq_h.init)(r[3], jnp.zeros((1, 88, HAND_DIM)), st_h),
        st_b, st_h, audio_enc,
        jax.jit(audio_enc.init)(r[4], jnp.zeros((1, 88, 64))),
        prior,
        jax.jit(prior.init)(r[5], jnp.zeros((1, 22, 2), jnp.int32),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 22, 256))))
    return JPipeline(face, face_vars, body)


@pytest.fixture(scope="module")
def pipes():
    jp = _jax_pipeline(0)
    tp = Pipeline.create(1, "cpu", wav2vec_cfg=Wav2Vec2Config(**TINY), **BODY)
    tp.load_converted(from_jax(jax.tree.map(np.asarray, jp.face_vars),
                               jax.tree.map(np.asarray, jp._body_arrays)))
    return jp, tp


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    t = np.arange(24000) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * np.random.default_rng(0).standard_normal(t.shape)
    path = str(tmp_path_factory.mktemp("wav") / "speech.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def _jax_noise(seed, H, S, K):
    """JAX's sampling noise for Pipeline.generate(seed): the gumbel block
    sample_tokens draws from PRNGKey(seed) (pixelcnn.py:306-315)."""
    keys01 = jax.vmap(jax.random.split)(jax.random.split(jax.random.PRNGKey(seed), H))
    return np.array(jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (S, K))))(keys01))


def test_generate_matches_jax(pipes, wav_file):
    jp, tp = pipes
    S, seed, K = 2, 3, BODY["code_num"]
    feat = taudio.get_mfcc(wav_file, device="cpu").numpy()
    H = feat.shape[0] // 4
    noise = torch.as_tensor(_jax_noise(seed, H, S, K))

    _, j_tok = jp._body_fn(jp._body_arrays, jp._decode_tables,
                           jnp.asarray(feat)[None].repeat(S, 0),
                           jnp.full((S,), 1, jnp.int32), jax.random.PRNGKey(seed))
    counts.clear()
    _, t_tok = tp.generate_conv(feat, 1, S, noise=noise)
    assert counts["sample_tokens_plain"] == 1
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))

    ref = jp.generate(wav_file, speaker="chemistry", num_samples=S, seed=seed)
    out = tp.generate(wav_file, speaker="chemistry", num_samples=S, noise=noise)
    assert out.shape == ref.shape == (S, 45, 265)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_generate_only_face_matches_jax(pipes, wav_file):
    jp, tp = pipes
    ref = jp.generate(wav_file, only_face=True)
    out = tp.generate(wav_file, only_face=True)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_generate_seeded_without_noise(pipes, wav_file):
    _, tp = pipes
    a = tp.generate(wav_file, num_samples=2, seed=5)
    b = tp.generate(wav_file, num_samples=2, seed=5)
    assert a.shape == (2, 45, 265) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_batches_over_32_decode_in_chunks(pipes):
    """generate_conv_poses splits S > 32 into sequential decodes; with the
    same noise the tokens equal one plain decode of the whole batch."""
    _, tp = pipes
    S, K = 34, BODY["code_num"]
    rng = np.random.default_rng(7)
    feat = torch.as_tensor(rng.standard_normal((S, 16, 64)), dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, 4, S))
    noise = torch.as_tensor(rng.gumbel(size=(4, 2, S, K)), dtype=torch.float32)
    counts.clear()
    _, tokens = generate_conv_poses(tp.body, feat, ids, noise=noise)
    assert counts["sample_tokens_plain"] == 2
    with torch.no_grad():
        want = sample_tokens(tp.body.prior, ids, tp.body.audio_enc(feat), noise=noise)
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())


def test_import_pulls_in_no_jax():
    code = ("import sys, talkshow_torch.pipeline, talkshow_torch.kernels.ar_decode, "
            "talkshow_torch.models.wav2vec_fused, talkshow_torch.kernels.wav2vec_layers, "
            "talkshow_torch.kernels.wav2vec_extractor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'talkshow_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

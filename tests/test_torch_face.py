"""Port wav2vec 2.0 encoder and face generator against flax at a toy
config, to atol 1e-4 (weights through talkshow_torch.convert)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models.face import FaceGenerator as JFace
from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
from talkshow_tpu.models.wav2vec import Wav2Vec2Encoder as JEnc
from talkshow_torch.convert import convert_face
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder

torch.set_num_threads(2)

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def wav():
    rng = np.random.default_rng(0)
    return (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)


@pytest.mark.parametrize("frames", [15, 9])
def test_wav2vec_encoder(wav, frames):
    jm = JEnc(JCfg(**TINY))
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(wav), frames), 1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(wav), frames))
    sd = convert_face({"params": {"audio_encoder": variables["params"]}})
    tm = Wav2Vec2Encoder(Wav2Vec2Config(**TINY)).eval()
    tm.load_state_dict({k[len("audio_encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = tm(torch.as_tensor(wav), frames).numpy()
    assert out.shape == ref.shape == (2, frames, 32)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_face_generator(wav):
    jm = JFace(wav2vec_cfg=JCfg(**TINY))
    onehot = np.eye(4, dtype=np.float32)[[1, 3]]
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(wav),
                                 jnp.asarray(onehot), 15), 2)
    ref = np.asarray(jm.apply(variables, jnp.asarray(wav), jnp.asarray(onehot), 15))
    tm = FaceGenerator(Wav2Vec2Config(**TINY)).eval()
    tm.load_state_dict(convert_face(variables))
    with torch.no_grad():
        out = tm(torch.as_tensor(wav), torch.as_tensor(onehot), 15).numpy()
    assert out.shape == ref.shape == (2, 15, 103)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_masked_face_generator_and_encoder(wav):
    """Length-masked path (second clip padded): the port's encoder and face
    generator equal flax's masked apply on real frames."""
    jm = JFace(wav2vec_cfg=JCfg(**TINY))
    onehot = np.eye(4, dtype=np.float32)[[0, 2]]
    padded = wav.copy()
    padded[1, 5000:] = 0.0
    vs, vf = np.array([8000, 5000], np.int32), np.array([15, 9], np.int32)
    variables = _perturb(jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(2), jnp.zeros((1, 3200)), jnp.zeros((1, 4)), 6), 5)
    ref, inter = jax.jit(
        lambda v, w, o, s, f: jm.apply(v, w, o, 15, valid_samples=s, valid_frames=f,
                                       capture_intermediates=lambda m, n: isinstance(m, JEnc)))(
        variables, jnp.asarray(padded), jnp.asarray(onehot), jnp.asarray(vs), jnp.asarray(vf))
    ref_enc = np.asarray(inter["intermediates"]["audio_encoder"]["__call__"][0])
    tm = FaceGenerator(Wav2Vec2Config(**TINY)).eval()
    tm.load_state_dict(convert_face(variables))
    args = (torch.as_tensor(vs), torch.as_tensor(vf))
    with torch.no_grad():
        enc = tm.audio_encoder(torch.as_tensor(padded), 15, *args).numpy()
        out = tm(torch.as_tensor(padded), torch.as_tensor(onehot), 15, *args).numpy()
    for b, n in enumerate(vf):
        np.testing.assert_allclose(enc[b, :n], ref_enc[b, :n], atol=1e-4)
        np.testing.assert_allclose(out[b, :n], np.asarray(ref)[b, :n], atol=1e-4)


def test_meshtalk_encoder_matches_flax():
    """MeshtalkEncoder (tests/test_misc_gaps.py's config): per-frame log mel,
    dilated VALID convs with cropped averaged residuals, the code; within
    1e-4; a frame's code reads only its own chunk."""
    from talkshow_tpu.models.face import MeshtalkEncoder as JMesh
    from talkshow_torch.convert import convert_meshtalk
    from talkshow_torch.models.face import MeshtalkEncoder
    chunks = (0.1 * np.random.default_rng(5).standard_normal((1, 2, 16000))).astype(np.float32)
    jm = JMesh(latent_dim=32)
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(chunks)), 3)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(chunks)))
    tm = MeshtalkEncoder(latent_dim=32).eval()
    tm.load_state_dict(convert_meshtalk(variables))
    with torch.no_grad():
        out = tm(torch.as_tensor(chunks))
        chunks2 = torch.as_tensor(chunks).clone()
        chunks2[0, 1] = chunks2[0, 1] * 2.0 + 0.01
        out2 = tm(chunks2)
    assert out.shape == ref.shape == (1, 2, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(out2[0, 0].numpy(), out[0, 0].numpy(), rtol=0, atol=0)
    assert (out2[0, 1] - out[0, 1]).abs().max() > 1e-4


def test_face_generator_meshtalk_matches_flax():
    from talkshow_tpu.models.face import FaceGeneratorMeshtalk as JMeshFace
    from talkshow_torch.convert import convert_meshtalk
    from talkshow_torch.models.face import FaceGeneratorMeshtalk
    chunks = (0.1 * np.random.default_rng(6).standard_normal((1, 2, 16000))).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[1]]
    jm = JMeshFace()
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(chunks),
                                          jnp.asarray(onehot)), 4)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(chunks), jnp.asarray(onehot)))
    tm = FaceGeneratorMeshtalk().eval()
    tm.load_state_dict(convert_meshtalk(variables))
    with torch.no_grad():
        out = tm(torch.as_tensor(chunks), torch.as_tensor(onehot)).numpy()
    assert out.shape == ref.shape == (1, 2, 103)
    np.testing.assert_allclose(out, ref, atol=1e-4)

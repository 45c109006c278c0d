"""Shared harness of the port's parity tests (it holds no tests itself): a
JAX pipeline at toy widths with its flax inits under jit, the port's
pipeline on the same weights (through `talkshow_torch.convert.from_jax`),
JAX's sampling noise as a block the port's decode takes, and a synthetic
speech wav."""
import wave

import numpy as np
import jax
import jax.numpy as jnp

from talkshow_tpu.models.body import BodyModels
from talkshow_tpu.models.face import FaceGenerator
from talkshow_tpu.models.pixelcnn import GatedPixelCNN
from talkshow_tpu.models.vqvae import VQVAE, AudioEncoder
from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
from talkshow_tpu.ops.pose import BODY_DIM, HAND_DIM
from talkshow_tpu.ops.vq import init_vq_state
from talkshow_tpu.pipeline import Pipeline as JPipeline
from talkshow_torch.convert import from_jax
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.pipeline import Pipeline

TINY = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
BODY = dict(num_hiddens=64, pixel_dim=16, pixel_layers=3, code_num=64)
K = BODY["code_num"]


def jax_pipeline(seed):
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


def pipeline_pair(seed=0):
    """(JAX pipeline, port pipeline on the CPU with the same weights)."""
    jp = jax_pipeline(seed)
    tp = Pipeline.create(seed + 1, "cpu", wav2vec_cfg=Wav2Vec2Config(**TINY), **BODY)
    tp.load_converted(from_jax(jax.tree.map(np.asarray, jp.face_vars),
                               jax.tree.map(np.asarray, jp._body_arrays)))
    return jp, tp


@jax.jit
def _gumbel_rows(row_keys, zeros):
    keys01 = jax.vmap(jax.random.split)(row_keys)
    return jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, zeros.shape)))(keys01)


def jax_noise_from_key(key, H, S, K):
    """The gumbel block (H, 2, S, K) the JAX sampler draws from `key`
    (pixelcnn.py:306-315): row keys split from it, each split in two."""
    return np.array(_gumbel_rows(jax.random.split(key, H), jnp.zeros((S, K))))


def jax_noise(seed, H, S, K):
    """JAX's sampling noise for Pipeline.generate(seed)."""
    return jax_noise_from_key(jax.random.PRNGKey(seed), H, S, K)


def write_wav(path, seconds, seed=0, freq=180.0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * freq * t) \
        + 0.05 * np.random.default_rng(seed).standard_normal(t.shape)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path

"""The port's fused face stage (models/wav2vec_fused.py) against the JAX
package's (talkshow_tpu/models/wav2vec_pallas.py, Pallas in interpret
mode, f32), at a toy config with weights through talkshow_torch.convert.
On the CPU the port runs the kernels' plain versions.  Tolerances: 2e-5
on real frames for the layer stack and the extractor (the same f32 math;
JAX's gelu uses a rational erf within 1.5e-7), 1e-4 for the whole face
stage, as the other face parity tests.  Also: masked_linear_interpolate
against JAX's, and the port's entry points default to CUDA (they raise
here, where there is none)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models import wav2vec_pallas as jfused
from talkshow_tpu.models.face import FaceGenerator as JFace
from talkshow_tpu.models.layers import masked_linear_interpolate as j_mli
from talkshow_tpu.models.wav2vec import FeatureExtractor as JExtractor
from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
from talkshow_tpu.models.wav2vec import Wav2Vec2Encoder as JEnc
from talkshow_torch.convert import convert_face
from talkshow_torch.kernels import counts
from talkshow_torch.models import wav2vec_fused as tfused
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.layers import masked_linear_interpolate
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder

torch.set_num_threads(2)

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
F32 = torch.float32


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def face_pair():
    jm = JFace(wav2vec_cfg=JCfg(**TINY))
    fv = _perturb(jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3200)), jnp.zeros((1, 4)), 6), 3)
    tm = FaceGenerator(Wav2Vec2Config(**TINY)).eval()
    tm.load_state_dict(convert_face(fv))
    return jm, fv, tm


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layers_fused_matches_jax(face_pair, masked):
    jm, fv, tm = face_pair
    x = np.random.default_rng(1).standard_normal((2, 15, 32)).astype(np.float32)
    vf = np.array([15, 9], np.int32) if masked else None
    ref = np.asarray(jfused.encoder_layers_fused(
        jm.wav2vec_cfg, fv["params"]["audio_encoder"], jnp.asarray(x),
        None if vf is None else jnp.asarray(vf), dtype=jnp.float32, interpret=True))
    counts.clear()
    out = tfused.encoder_layers_fused(tm.audio_encoder, torch.as_tensor(x),
                                      None if vf is None else torch.as_tensor(vf),
                                      dtype=F32).numpy()
    assert counts["encoder_layers_plain"] == 1 and counts["wav2vec_layers"] == 0
    for b, n in enumerate([15, 9] if masked else [15, 15]):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=2e-5)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("ks,ss,dims", [
    ((10, 3), (5, 2), (16, 16)),
    ((10, 3, 2), (5, 2, 2), (24, 24, 24)),
    ((10, 3, 3, 2), (5, 2, 2, 2), (16,) * 4),
])
def test_extractor_fused_matches_jax(ks, ss, dims):
    cfg = dict(TINY, conv_dim=dims, conv_kernel=ks, conv_stride=ss)
    jcfg = JCfg(**cfg)
    x = (np.random.default_rng(0).standard_normal((2, 7000)) * 0.5).astype(np.float32)
    fe = _perturb(jax.jit(JExtractor(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 400))), 4)
    params = {"feature_extractor": fe["params"]}
    ref = np.asarray(jfused.extractor_fused(jcfg, params, jnp.asarray(x),
                                            dtype=jnp.float32, interpret=True))
    enc = Wav2Vec2Encoder(Wav2Vec2Config(**cfg)).eval()
    sd = convert_face({"params": {"audio_encoder": params}})
    enc.feature_extractor.load_state_dict(
        {k[len("audio_encoder.feature_extractor."):]: v for k, v in sd.items()})
    out = tfused.extractor_fused(enc, torch.as_tensor(x), dtype=F32).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_face_apply_fused_matches_jax(face_pair, masked):
    jm, fv, tm = face_pair
    wav = (np.random.default_rng(1).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[0, 2]]
    kw, tkw, n_valid = {}, {}, [15, 15]
    if masked:
        wav[1, 4800:] = 0.0
        vs, vf = np.array([8000, 4800], np.int32), np.array([15, 9], np.int32)
        kw = dict(valid_samples=jnp.asarray(vs), valid_frames=jnp.asarray(vf))
        tkw = dict(valid_samples=torch.as_tensor(vs), valid_frames=torch.as_tensor(vf))
        n_valid = [15, 9]
    ref = np.asarray(jfused.face_apply_fused(jm, fv, jnp.asarray(wav), jnp.asarray(onehot),
                                             15, dtype=jnp.float32, interpret=True, **kw))
    counts.clear()
    out = tfused.face_apply_fused(tm, torch.as_tensor(wav), torch.as_tensor(onehot), 15,
                                  dtype=F32, **tkw).numpy()
    assert counts["encoder_layers_plain"] == 1 and counts["extractor_plain"] == 1
    assert out.shape == ref.shape == (2, 15, 103)
    for b, n in enumerate(n_valid):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=1e-4)


def test_masked_linear_interpolate_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 4)).astype(np.float32)
    in_valid, out_valid = np.array([20, 13, 7], np.int32), np.array([12, 8, 4], np.int32)
    ref = np.asarray(j_mli(jnp.asarray(x), 12, jnp.asarray(in_valid), jnp.asarray(out_valid)))
    out = masked_linear_interpolate(torch.as_tensor(x), 12, torch.as_tensor(in_valid),
                                    torch.as_tensor(out_valid)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def _create_pipeline():
    from talkshow_torch.pipeline import Pipeline
    return Pipeline.create(0, wav2vec_cfg=Wav2Vec2Config(**TINY), num_hiddens=64,
                           pixel_dim=16, pixel_layers=3, code_num=64)


def _create_body_models():
    from talkshow_torch.models.body import create_body_models
    return create_body_models(torch.Generator().manual_seed(0), code_num=64,
                              num_hiddens=64, pixel_dim=16, pixel_layers=3)


def _get_mfcc(tmp_path):
    import wave

    from talkshow_torch.ops.audio import get_mfcc
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(1600, "<i2").tobytes())
    return get_mfcc(path)


def _init_vq_state():
    from talkshow_torch.ops.vq import init_vq_state
    return init_vq_state(torch.Generator().manual_seed(0), 64, 16)


@pytest.mark.parametrize("entry", [_create_pipeline, _create_body_models, _get_mfcc,
                                   _init_vq_state], ids=lambda f: f.__name__.lstrip("_"))
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would succeed")
    args = (tmp_path,) if entry is _get_mfcc else ()
    with pytest.raises((RuntimeError, AssertionError)):
        entry(*args)

"""The port's whole slice against the JAX package: Pipeline.generate on one
synthetic wav with the same weights and the same sampling noise gives the
same tokens and the same motion (atol 1e-4), and so do the continuity
decode and the bucketed `generate_body(pad_to_bucket=)`; `get_mfcc_sepa`
equals JAX's (1e-3 dB, as tests/test_torch_ops.py holds `mfcc`); the
port's own weights file round-trips; importing the port pulls in no JAX."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.ops import audio as jaudio
from talkshow_torch.kernels import counts
from talkshow_torch.models.body import generate_conv_poses
from talkshow_torch.models.pixelcnn import sample_tokens
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops import audio as taudio
from talkshow_torch.ops.pose import C_INDEX_3D
from talkshow_torch.pipeline import Pipeline, load_pipeline, save_pipeline
from test_torch_harness import BODY, TINY, jax_noise, jax_noise_from_key, pipeline_pair, write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pipes():
    return pipeline_pair(0)


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    return write_wav(str(tmp_path_factory.mktemp("wav") / "speech.wav"), 1.5)


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    """Longer than the 2 s split of the continuity path."""
    return write_wav(str(tmp_path_factory.mktemp("wav") / "long.wav"), 3.2, seed=1, freq=240.0)


def test_generate_matches_jax(pipes, wav_file):
    jp, tp = pipes
    S, seed, K = 2, 3, BODY["code_num"]
    feat = taudio.get_mfcc(wav_file, device="cpu").numpy()
    H = feat.shape[0] // 4
    noise = torch.as_tensor(jax_noise(seed, H, S, K))

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


def test_generate_face_routes_plain_on_cpu(pipes, wav_file):
    """On the CPU the face stage is the plain one and no tables are packed;
    with_face_dtype keeps the modules and changes only the table type."""
    _, tp = pipes
    counts.clear()
    tp.generate(wav_file, only_face=True)
    assert counts["face_plain"] == 1 and counts["wav2vec_layers"] == 0
    assert tp._face_tables is None
    p32 = tp.with_face_dtype(torch.float32)
    assert p32.face_model is tp.face_model and p32.face_dtype == torch.float32
    assert tp.face_dtype == torch.bfloat16


def test_get_mfcc_sepa_matches_jax(long_wav):
    feat, gap = taudio.get_mfcc_sepa(long_wav, sr=22000, device="cpu")
    ref, ref_gap = jaudio.get_mfcc_sepa(long_wav, sr=22000)
    assert gap == ref_gap and feat.shape == ref.shape
    np.testing.assert_allclose(feat.numpy(), ref, atol=1e-3)
    feat16, gap16 = taudio.get_mfcc_sepa(long_wav, device="cpu")   # JAX's default, 16 kHz
    ref16, ref_gap16 = jaudio.get_mfcc_sepa(long_wav)
    assert gap16 == ref_gap16
    np.testing.assert_allclose(feat16.numpy(), ref16, atol=1e-3)


def test_continuity_matches_jax(pipes, long_wav):
    """generate(continuity=True): the first 2 s sampled, then the whole grid
    with them as a teacher-forced prefix.  JAX splits PRNGKey(seed) into
    one key a decode; the port takes the two blocks those keys draw."""
    jp, tp = pipes
    S, seed, speaker = 2, 4, 2
    feat, gap = taudio.get_mfcc_sepa(long_wav, sr=22000, device="cpu")
    h0, H = gap // 4, feat.shape[0] // 4
    r0, r1 = jax.random.split(jax.random.PRNGKey(seed))
    noise = (torch.as_tensor(jax_noise_from_key(r0, h0, S, BODY["code_num"])),
             torch.as_tensor(jax_noise_from_key(r1, H, S, BODY["code_num"])))

    counts.clear()
    _, tok0, tok = tp.generate_conv_continuity(feat, gap, speaker, S, noise=noise)
    assert counts["sample_tokens_plain"] == 2
    assert tok0.shape == (S, h0, 2) and tok.shape == (S, H, 2)
    np.testing.assert_array_equal(tok[:, :h0].numpy(), tok0.numpy())
    ids = jnp.full((S,), speaker, jnp.int32)
    jf = jnp.asarray(feat.numpy())[None].repeat(S, 0)
    _, j_tok0 = jp._body_fn(jp._body_arrays, jp._decode_tables, jf[:, :gap], ids, r0)
    prefix = jnp.zeros((S, H, 2), jnp.int32).at[:, :h0].set(j_tok0)
    _, j_tok = jp._body_prefix_fn(jp._body_arrays, jp._decode_tables, jf, ids, r1, prefix, h0)
    np.testing.assert_array_equal(tok0.numpy(), np.asarray(j_tok0))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))

    ref = jp.generate(long_wav, speaker=speaker, num_samples=S, seed=seed, continuity=True)
    out = tp.generate(long_wav, speaker=speaker, num_samples=S, noise=noise, continuity=True)
    assert out.shape == ref.shape == (S, 96, 265)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_pad_to_bucket_matches_jax(pipes, wav_file):
    """generate_body(pad_to_bucket=8): features padded to 32-frame
    multiples, tail cropped; JAX's noise covers the padded rows."""
    jp, tp = pipes
    S, seed, bucket = 2, 6, 8
    feat = taudio.get_mfcc(wav_file, device="cpu").numpy()[:43]     # not a multiple of 4
    Hp = -(-43 // (4 * bucket)) * bucket
    noise = torch.as_tensor(jax_noise(seed, Hp, S, BODY["code_num"]))
    ref = np.asarray(jp.generate_body(feat, 3, S, seed, pad_to_bucket=bucket))
    out = tp.generate_body(feat, 3, S, noise=noise, pad_to_bucket=bucket)
    assert out.shape == ref.shape == (S, 40, 129)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_norm_stats_denormalize_the_body(pipes, wav_file, tmp_path):
    """with_norm_stats, as a tuple over the 165 pose channels or a
    norm_stats.npy path, denormalizes the conv channels (JAX's
    _denorm_conv slicing)."""
    _, tp = pipes
    rng = np.random.default_rng(3)
    mean, std = rng.standard_normal(165).astype(np.float32), rng.random(165).astype(np.float32)
    feat = taudio.get_mfcc(wav_file, device="cpu").numpy()
    plain = tp.generate_body(feat, 0, 1, seed=2)
    np.save(tmp_path / "norm_stats.npy", np.stack([mean, std]))
    for stats in ((mean, std), str(tmp_path / "norm_stats.npy")):
        out = tp.with_norm_stats(stats).generate_body(feat, 0, 1, seed=2)
        np.testing.assert_allclose(out, plain * std[C_INDEX_3D] + mean[C_INDEX_3D], atol=1e-6)
    assert tp.norm_stats is None


def test_save_load_pipeline_round_trip(pipes, wav_file, tmp_path):
    _, tp = pipes
    path = str(tmp_path / "pipe.pt")
    save_pipeline(tp, path)
    other = Pipeline.create(9, "cpu", wav2vec_cfg=Wav2Vec2Config(**TINY), **BODY)
    loaded = load_pipeline(path, template=other)
    for name, m in tp._modules().items():
        got = loaded._modules()[name].state_dict()
        assert all(torch.equal(v, got[k]) for k, v in m.state_dict().items())
    for a, b in zip(tp.body.vq_body_state + tp.body.vq_hand_state,
                    loaded.body.vq_body_state + loaded.body.vq_hand_state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(loaded.generate(wav_file, num_samples=1, seed=1),
                                  tp.generate(wav_file, num_samples=1, seed=1))


def test_import_pulls_in_no_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX,
    flax, transformers or the JAX package; the entry points (demo,
    diversity, continuity, convert_checkpoints, legacy_eval, full_schedule,
    eval_full_schedule) and the renderer import no cv2 either (the writer
    imports it when it runs), and nothing imports matplotlib at the top
    (the schedule's curve plot imports it when it runs)."""
    code = ("import sys, pkgutil, importlib, talkshow_torch, chip_smoke; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(talkshow_torch.__path__, 'talkshow_torch.')]; "
            "import talkshow_torch.pipeline, talkshow_torch.serving, talkshow_torch.streaming; "
            "import talkshow_torch.demo, talkshow_torch.diversity, talkshow_torch.continuity, "
            "talkshow_torch.convert_checkpoints, talkshow_torch.legacy_eval, "
            "talkshow_torch.render, talkshow_torch.native, talkshow_torch.models.causal_vqvae, "
            "talkshow_torch.full_schedule, talkshow_torch.eval_full_schedule, "
            "talkshow_torch.utils, talkshow_torch.models.s2g_legacy, "
            "talkshow_torch.data.synthetic_show; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'transformers', 'talkshow_tpu', 'cv2', 'matplotlib')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

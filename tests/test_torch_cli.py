"""The port's user entry points (`python -m talkshow_torch.demo`,
`.diversity`, `.continuity`, `.convert_checkpoints`, `.legacy_eval`)
against the JAX package's scripts on the CPU, each called through its
`main(argv)` in this process.

Both sides run the same toy weights: `Pipeline.create` of each package is
patched to return the pair of `test_torch_harness.pipeline_pair` (the
continuity script's --tiny widths), and the port's sampler is given the
noise the JAX script's sampler draws (`jax_noise` of the script's seed; the
entry points take no noise, so the test wraps the pipeline's `generate` /
`generate_body` to pass it).  Tolerances: motion within 1e-4 (the
pipeline tests' tolerance), diversity scores within 1e-4 relative, the
LS3DCG demo within 1e-5 of max|motion| with one MFCC array fed to both
sides (tests/test_torch_ls3dcg.py's tolerance), converted weights and the
legacy metrics equal exactly.  Where the JAX script writes an orbax tree
(convert_checkpoints), the port's file is held to the JAX converter's
tensors mapped by `convert.convert_*`.  Modes that only the port
exercises here (--streaming, --norm_stats, --face_f32, --tiny of
diversity) pin the saved layout, shapes and file names."""
import json
import os
import runpy
import sys
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import talkshow_tpu.pipeline as jpipeline
from talkshow_torch import continuity, convert, convert_checkpoints, demo, diversity, legacy_eval
from talkshow_torch import pipeline as tpipeline
from talkshow_torch.kernels import counts
from talkshow_torch.models.ls3dcg import LS3DCGGenerator
from talkshow_torch.ops import audio as taudio
from test_torch_harness import BODY, jax_noise, jax_noise_from_key, pipeline_pair, write_wav

torch.set_num_threads(2)
REPO = os.path.join(os.path.dirname(__file__), "..")
GOLD = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
K = BODY["code_num"]


def _script(name, argv):
    """Run scripts/<name>.py as __main__ with argv (JAX side)."""
    old = sys.argv
    sys.argv = [name + ".py", *argv]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name + ".py"), run_name="__main__")
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def pipes():
    return pipeline_pair(0)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return write_wav(str(tmp_path_factory.mktemp("wav") / "speech.wav"), 1.5)


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    """Longer than the 2 s split of the continuity path."""
    return write_wav(str(tmp_path_factory.mktemp("wav") / "long.wav"), 3.2, seed=1, freq=240.0)


@pytest.fixture
def patched(pipes, monkeypatch):
    """Both packages' Pipeline.create return the toy pair; the port's
    `generate` and `generate_body` take JAX's noise for their seed."""
    jp, tp = pipes
    monkeypatch.setattr(jpipeline.Pipeline, "create", classmethod(lambda cls, *a, **k: jp))
    monkeypatch.setattr(tpipeline.Pipeline, "create", classmethod(lambda cls, *a, **k: tp))
    gen, body = tp.generate, tp.generate_body

    def generate(wav_file, speaker=0, num_samples=1, only_face=False, stand=False, seed=0,
                 continuity=False, **kw):
        if continuity:
            feat, gap = taudio.get_mfcc_sepa(wav_file, sr=22000, device="cpu")
            r0, r1 = jax.random.split(jax.random.PRNGKey(seed))
            noise = (torch.as_tensor(jax_noise_from_key(r0, gap // 4, num_samples, K)),
                     torch.as_tensor(jax_noise_from_key(r1, feat.shape[0] // 4,
                                                        num_samples, K)))
        else:
            H = taudio.get_mfcc(wav_file, device="cpu").shape[0] // 4
            noise = torch.as_tensor(jax_noise(seed, H, num_samples, K))
        return gen(wav_file, speaker, num_samples, only_face, stand, seed, noise=noise,
                   continuity=continuity, **kw)

    def generate_body(feat, speaker, num_samples=1, seed=0, noise=None, **kw):
        if noise is None:
            noise = torch.as_tensor(jax_noise(seed, np.asarray(feat).shape[0] // 4,
                                              num_samples, K))
        return body(feat, speaker, num_samples, seed, noise, **kw)

    monkeypatch.setattr(tp, "generate", generate)
    monkeypatch.setattr(tp, "generate_body", generate_body)
    return jp, tp


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--only_face"], ["--continuity"], ["--stand"]],
                         ids=["default", "only_face", "continuity", "stand"])
def test_demo_matches_jax_script(patched, wav, long_wav, tmp_path, extra):
    audio = long_wav if "--continuity" in extra else wav
    argv = ["--audio_file", audio, "--id", "1", "--num_sample", "2", "--seed", "3", *extra]
    _script("demo", argv + ["--out_dir", str(tmp_path / "jax")])
    motion = demo.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    stem = os.path.splitext(os.path.basename(audio))[0]
    want = np.load(tmp_path / "jax" / f"{stem}.npy")
    got = np.load(tmp_path / "port" / f"{stem}.npy")
    rows = {"--only_face": 45, "--continuity": 2 * 96}.get(extra[0] if extra else "", 2 * 45)
    assert got.shape == want.shape == (rows, 265)
    np.testing.assert_array_equal(got, motion.reshape(-1, 265))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_demo_default_equals_generate(pipes, wav, tmp_path, monkeypatch):
    """The demo's file is `Pipeline.generate` with the same seed, bit for
    bit, its samples concatenated on time."""
    _, tp = pipes
    monkeypatch.setattr(tpipeline.Pipeline, "create", classmethod(lambda cls, *a, **k: tp))
    motion = demo.main(["--audio_file", wav, "--num_sample", "2", "--seed", "5",
                        "--out_dir", str(tmp_path), "--device", "cpu"])
    want = tp.generate(wav, speaker=0, num_samples=2, seed=5)
    np.testing.assert_array_equal(motion, want)
    np.testing.assert_array_equal(np.load(tmp_path / "speech.npy"), want.reshape(90, 265))


def test_demo_streaming_norm_stats_and_face_f32(pipes, wav, tmp_path, monkeypatch):
    """--streaming feeds 1 s blocks to StreamingSession ((1, T, 265)); with
    --norm_stats the body channels are denormalized; --face_f32 selects f32
    face tables (the CPU's plain face stage is the same)."""
    _, tp = pipes
    monkeypatch.setattr(tpipeline.Pipeline, "create", classmethod(lambda cls, *a, **k: tp))
    base = ["--audio_file", wav, "--device", "cpu", "--out_dir", str(tmp_path)]
    fed = []
    feed = demo.StreamingSession.feed
    monkeypatch.setattr(demo.StreamingSession, "feed",
                        lambda self, w: fed.append(len(w)) or feed(self, w))
    stream = demo.main(base + ["--streaming"])
    assert stream.shape == (1, 45, 265) and np.isfinite(stream).all()
    assert fed == [16000, 8000]
    with pytest.raises(SystemExit, match="--streaming"):
        demo.main(base + ["--streaming", "--num_sample", "2"])
    rng = np.random.default_rng(3)
    stats = np.stack([rng.standard_normal(165), rng.uniform(0.5, 1.5, 165)]).astype(np.float32)
    np.save(tmp_path / "norm.npy", stats)
    plain = demo.main(base + ["--seed", "2"])
    normed = demo.main(base + ["--seed", "2", "--norm_stats", str(tmp_path / "norm.npy")])
    assert not np.allclose(plain, normed)
    np.testing.assert_allclose(demo.main(base + ["--seed", "2", "--face_f32"]), plain, atol=0)


def test_demo_ls3dcg_matches_jax_script(wav, tmp_path, monkeypatch):
    """--model ls3dcg: the JAX script's random generator (flax init at
    --seed) written as a port s2g_LS3DCG checkpoint, and the same MFCC."""
    from talkshow_tpu.models.ls3dcg import LS3DCGGenerator as JGen
    from talkshow_tpu.ops import audio as jaudio
    v = jax.jit(JGen().init)(jax.random.PRNGKey(4), jnp.zeros((1, 8, 64)))
    sd = convert.convert_ls3dcg(jax.tree.map(np.asarray, {"params": v["params"],
                                                          "batch_stats": v["batch_stats"]}))
    LS3DCGGenerator().load_state_dict(sd)
    torch.save({"state": {"models": {"gen": sd}}}, tmp_path / "ckpt-0.pt")
    feat = np.random.default_rng(8).standard_normal((45, 64)).astype(np.float32)
    monkeypatch.setattr(jaudio, "get_mfcc", lambda *a, **k: feat)
    monkeypatch.setattr(taudio, "get_mfcc", lambda *a, device="cuda", **k:
                        torch.as_tensor(feat, device=device))
    argv = ["--audio_file", wav, "--model", "ls3dcg", "--num_sample", "2"]
    _script("demo", argv + ["--seed", "4", "--out_dir", str(tmp_path / "jax")])
    demo.main(argv + ["--ls3dcg_ckpt", str(tmp_path / "ckpt-0.pt"), "--device", "cpu",
                      "--out_dir", str(tmp_path / "port")])
    want = np.load(tmp_path / "jax" / "speech.npy")
    got = np.load(tmp_path / "port" / "speech.npy")
    assert got.shape == want.shape == (90, 265)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# diversity and continuity
# ---------------------------------------------------------------------------

def test_diversity_matches_jax_script(patched, wav, tmp_path, capsys):
    argv = ["--audio_file", wav, "--num_sample", "3"]
    _script("diversity", argv + ["--out_dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts.clear()
    got = diversity.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert counts["sample_tokens_plain"] == 4                 # one decode a speaker
    assert got.keys() == want.keys() == {f"diversity_speaker{s}" for s in range(4)}
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
    a = np.load(tmp_path / "jax" / "speech_diversity.npy")
    b = np.load(tmp_path / "port" / "speech_diversity.npy")
    assert b.shape == a.shape == (4, 3, 44, 129)
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_diversity_tiny_widths(wav, tmp_path):
    """--tiny: the JAX script's tiny models (scripts/diversity.py:44-51)."""
    scores = diversity.main(["--audio_file", wav, "--num_sample", "2", "--tiny",
                             "--out_dir", str(tmp_path), "--device", "cpu"])
    assert all(np.isfinite(v) and v >= 0 for v in scores.values())
    motion = np.load(tmp_path / "speech_diversity.npy")
    assert motion.shape == (4, 2, 44, 129) and np.isfinite(motion).all()
    assert diversity.TINY_BODY == dict(code_num=64, embedding_dim=16, num_hiddens=32,
                                       pixel_dim=32, pixel_layers=2)


def test_continuity_matches_jax_script(patched, long_wav, tmp_path):
    argv = ["--audio_file", long_wav, "--id", "2", "--tiny"]
    _script("continuity", argv + ["--out_dir", str(tmp_path / "jax")])
    counts.clear()
    continuity.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert counts["sample_tokens_plain"] == 2
    want = np.load(tmp_path / "jax" / "long_continuity.npy")
    got = np.load(tmp_path / "port" / "long_continuity.npy")
    assert got.shape == want.shape == (96, 265)
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# convert_checkpoints
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(got: dict, want: dict):
    """Equal tensors under JAX's names; the port's file also carries the
    BatchNorm counters (`num_batches_tracked`) that flax has no leaf for."""
    extra = set(got) - set(want)
    assert set(want) <= set(got) and all(k.endswith("num_batches_tracked") for k in extra), \
        sorted(set(got) ^ set(want))
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _golden_meta():
    with open(os.path.join(GOLD, "meta.json")) as f:
        return json.load(f)


def test_convert_body_vq_matches_jax_converter(tmp_path):
    from talkshow_tpu.convert import talkshow as ts
    out = convert_checkpoints.main(["body_vq", "--src", os.path.join(GOLD, "body_vq.pth"),
                                    "--out", str(tmp_path / "vq.pt")])
    want = ts.convert_body_vq_checkpoint(torch.load(os.path.join(GOLD, "body_vq.pth"),
                                                    weights_only=False))
    saved = torch.load(tmp_path / "vq.pt", weights_only=True)
    for part, key in (("body", "vq_body"), ("hand", "vq_hand")):
        variables, state = want[part]
        _equal(saved[key], convert.convert_vqvae(_np(variables)))
        np.testing.assert_array_equal(saved[key + "_state"]["embeddings"].numpy(),
                                      np.asarray(state.embeddings))
    assert saved.keys() == out.keys()


@pytest.mark.parametrize("bh_model", ["true", "false"])
def test_convert_body_pixel_matches_jax_converter(tmp_path, capsys, bh_model):
    """The prior's depth is inferred (the golden prior has 3 layers); with
    --bh_model false both converters keep only the vertical-only prior's
    weights (JAX's keeps fusion_h, which the port drops)."""
    from talkshow_tpu.convert import talkshow as ts
    ckpt = torch.load(os.path.join(GOLD, "body_pixel.pth"), weights_only=False)
    convert_checkpoints.main(["body_pixel", "--src", os.path.join(GOLD, "body_pixel.pth"),
                              "--out", str(tmp_path / "px.pt"), "--bh_model", bh_model])
    assert "prior: 3 layers" in capsys.readouterr().out
    saved = torch.load(tmp_path / "px.pt", weights_only=True)
    bh = bh_model == "true"
    gen = ckpt["generator"]
    prior = ts.convert_pixelcnn(convert.strip_module_prefix(gen["generator"]), bh_model=bh)
    _equal(saved["prior"], convert.convert_pixelcnn(_np(prior), bh_model=bh))
    _equal(saved["audio_enc"], convert.convert_audio_encoder(
        _np(ts.convert_audio_encoder(gen["audioencoder"]))))
    assert any("fusion_h" in k for k in saved["prior"]) == bh


def test_convert_face_matches_jax_and_loads_into_a_pipeline(tmp_path):
    """The face file equals the JAX converter's tensors and, with the other
    two kinds' files, loads into a pipeline of the fixtures' widths through
    `load_pipeline`, whose face stage reproduces the replica's output
    (5e-4, tests/test_torch_reference_ckpt.py's tolerance)."""
    from talkshow_tpu.convert import talkshow as ts
    from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
    meta = _golden_meta()
    cfg = convert.config_from_hf(meta["hf_wav2vec"])
    for kind, name in (("face", "face.pth"), ("body_vq", "body_vq.pth"),
                       ("body_pixel", "body_pixel.pth")):
        convert_checkpoints.main([kind, "--src", os.path.join(GOLD, name),
                                  "--out", str(tmp_path / f"{kind}.pt")])
    jcfg = JCfg(**{f: getattr(cfg, f) for f in JCfg.__dataclass_fields__})
    want = ts.convert_face_checkpoint(torch.load(os.path.join(GOLD, "face.pth"),
                                                 weights_only=False), jcfg)
    saved = torch.load(tmp_path / "face.pt", weights_only=True)
    got, ref = saved["face"], convert.convert_face(_np(want))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    px = meta["pixel"]
    pipe = tpipeline.Pipeline.create(0, "cpu", cfg, num_hiddens=meta["vq_hid"], code_num=px["K"],
                                     pixel_dim=px["dim"], pixel_layers=px["n_layers"],
                                     audio_channels=px["aud_ch"])
    for kind in ("face", "body_vq", "body_pixel"):
        tpipeline.load_pipeline(str(tmp_path / f"{kind}.pt"), template=pipe)
    exp = dict(np.load(os.path.join(GOLD, "expected.npz")))
    face = pipe.generate_face(exp["face_wav"], frame=exp["face_out"].shape[1])
    np.testing.assert_allclose(face[None], exp["face_out"], atol=5e-4)


def _hf_snapshot(path, fmt):
    """A Hugging Face Wav2Vec2ForCTC snapshot of the golden face's encoder:
    config.json and the weights under `wav2vec2.` with an lm_head."""
    meta = _golden_meta()
    face = torch.load(os.path.join(GOLD, "face.pth"), weights_only=True)
    sd = face
    while "generator" in sd and not any("." in k for k in sd):
        sd = sd["generator"]
    sd = convert.strip_module_prefix(sd)
    enc = {k[len("audio_encoder."):]: v.float().contiguous() for k, v in sd.items()
           if k.startswith("audio_encoder.")}
    hf = {"wav2vec2." + k: v for k, v in enc.items()}
    hf["lm_head.weight"] = torch.zeros(32, meta["hf_wav2vec"]["hidden_size"])
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta["hf_wav2vec"], f)
    if fmt == "bin":
        torch.save(hf, os.path.join(path, "pytorch_model.bin"))
    else:
        from safetensors.torch import save_file
        save_file(hf, os.path.join(path, "model.safetensors"))
    return enc, convert.config_from_hf(meta["hf_wav2vec"])


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_wav2vec_snapshot_matches_jax_converter(tmp_path, fmt):
    from talkshow_tpu.convert.wav2vec import convert_wav2vec2
    from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
    enc, cfg = _hf_snapshot(str(tmp_path / "snap"), fmt)
    convert_checkpoints.main(["wav2vec", "--src", str(tmp_path / "snap"),
                              "--out", str(tmp_path / "w2v.pt")])
    saved = torch.load(tmp_path / "w2v.pt", weights_only=True)
    assert saved["config"]["hidden_size"] == cfg.hidden_size
    jcfg = JCfg(**{f: getattr(cfg, f) for f in JCfg.__dataclass_fields__})
    params = convert_wav2vec2({k: v.numpy() for k, v in enc.items()}, jcfg)
    ref = {k[len("audio_encoder."):]: v for k, v in convert.convert_face(
        _np({"params": {"audio_encoder": params}})).items()}
    assert saved["wav2vec"].keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(saved["wav2vec"][k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_convert_wav2vec_without_snapshot_exits(tmp_path):
    with pytest.raises(SystemExit, match="no Hugging Face wav2vec 2.0 snapshot"):
        convert_checkpoints.main(["wav2vec", "--src", str(tmp_path / "missing"),
                                  "--out", str(tmp_path / "w2v.pt")])
    assert not os.path.exists(tmp_path / "w2v.pt")


# ---------------------------------------------------------------------------
# legacy_eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_root(tmp_path_factory):
    """One speaker, one 60-frame val clip in the pose_dataset layout, its wav
    and two prediction files (tests/test_legacy_eval_cli.py's tree)."""
    from tests.test_legacy2d_ingest import _write_clip
    root = tmp_path_factory.mktemp("pose_dataset")
    speaker, vid, clipname = "oliver", "vidA", "0000000001"
    _write_clip(str(root / speaker / "clips" / vid / "images" / "half" / "val" / clipname),
                T=60, seed=1)
    aud_dir = root / "test_audios" / speaker
    os.makedirs(aud_dir)
    with wave.open(str(aud_dir / f"{clipname}_{vid}.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(1600, "<i2").tobytes())
    rng = np.random.default_rng(7)
    for pf in ("base", "other"):
        with open(str(aud_dir / f"{clipname}_{vid}_{pf}.json"), "w") as f:
            json.dump(rng.normal(0, 1, (2, 60, 108)).tolist(), f)
    return str(root)


@pytest.mark.parametrize("mode", ["diversity_lvd", "peak_velocity", "mode_transition",
                                  "quality_samples"])
def test_legacy_eval_matches_jax_script(pose_root, tmp_path, capsys, mode):
    argv = ["--mode", mode, "--speaker", "oliver", "--root", pose_root, "--split", "val",
            "--post_fix", "base", "other"]
    _script("legacy_eval", argv + ["--out_dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = legacy_eval.main(argv + ["--out_dir", str(tmp_path / "port")])
    if mode == "quality_samples":
        assert got["keys"] == want["keys"]
        with open(got["saved"]) as f, open(want["saved"]) as g:
            assert json.load(f) == json.load(g)
    else:
        assert got == want
    dumps = sorted(os.listdir(tmp_path / "jax")) if mode == "peak_velocity" else []
    assert dumps == ["oliver_gt.npy", "oliver_pred.npy"] or mode != "peak_velocity"
    for name in dumps:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                          np.load(tmp_path / "jax" / name))

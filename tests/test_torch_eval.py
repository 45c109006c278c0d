"""The port's evaluation path (talkshow_torch/eval, ops/audio.onset_times,
data/dataset.ShowDataset.from_root) against the JAX package on the CPU, at
toy widths (tests/test_torch_harness.py's pipeline, an AE of 64 hidden).

Tolerances: FGD in f32 within 1e-4 relative of JAX's f32 value (two
eigendecompositions; LAPACK and XLA order their sums differently), the
numpy parts equal exactly (the same code on the same arrays: the f64
Fréchet distance, the bootstrap's draws under one seed, the CIs, the
paired gaps, diversity, MAAC, beat consistency, the legacy 2-D suite).
`lvd` / `batch_lvd` within 1e-6 relative.  Onset times equal (the power
spectrogram within f32 rounding can only move a peak that sits on a
threshold; the written clip has none).  `from_root` gives the same clips:
poses, expression and betas equal, the MFCC within 1e-4 of its largest
magnitude (JAX's side pinned to its jnp `get_mfcc`).  The three runners
under JAX's per-clip noise: tokens equal, every metric within 1e-4
relative (the motion through the same f32 layers, the SMPL-X rig's joints
and vertices within 1e-5)."""
import json
import os
import pickle
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.data import dataset as jdata
from talkshow_tpu.eval import fgd as jfgd
from talkshow_tpu.eval import legacy2d as jl2d
from talkshow_tpu.eval import metrics as jm
from talkshow_tpu.eval import runners as jrun
from talkshow_tpu.models.vqvae import AE as JAE
from talkshow_tpu.ops import audio as jaudio
from talkshow_tpu.ops import smplx_lbs as jlbs
from talkshow_torch import convert
from talkshow_torch.data import dataset as tdata
from talkshow_torch.eval import __main__ as tcli
from talkshow_torch.eval import fgd as tfgd
from talkshow_torch.eval import legacy2d as tl2d
from talkshow_torch.eval import metrics as tm
from talkshow_torch.eval import runners as trun
from talkshow_torch.kernels import counts
from talkshow_torch.models.vqvae import AE
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops import audio as taudio
from talkshow_torch.ops import smplx_lbs as tlbs
from talkshow_torch.pipeline import Pipeline
from test_torch_harness import BODY, TINY, K, jax_noise_from_key, pipeline_pair, write_wav

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NH = 64


def _rel(a, b, tol=1e-4):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


# ---------------------------------------------------------------------------
# FGD and the metrics
# ---------------------------------------------------------------------------

def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 12)).astype(np.float32)
    b = (rng.standard_normal((250, 12)) * 1.4 + 0.5).astype(np.float32)
    want = float(jfgd.frechet_distance(jnp.asarray(a), jnp.asarray(b)))
    _rel(tfgd.frechet_distance(torch.as_tensor(a), torch.as_tensor(b)), want)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert tfgd.frechet_distance_np(a64, b64) == jfgd.frechet_distance_np(a64, b64)
    _rel(tfgd.frechet_distance(torch.as_tensor(a64), torch.as_tensor(b64)),
         jfgd.frechet_distance_np(a64, b64), 1e-9)


class _Id:
    """A JAX `AE` stand-in whose features are its input."""

    def apply(self, vars_, x, method=None):
        return x


def test_bootstrap_fgd_draws_equal_jax_under_one_seed():
    rng = np.random.default_rng(1)
    arms = []
    for shift in (0.0, 0.5):
        ev_t, ev_j = tfgd.FGDEvaluator(AE(8, 4, 16)), jfgd.FGDEvaluator(_Id(), {})
        for _ in range(6):
            real = rng.standard_normal((20, 4)).astype(np.float32)
            gen = (real + shift + 0.3 * rng.standard_normal((20, 4))).astype(np.float32)
            for ev in (ev_t, ev_j):
                ev.real_feats.append(real)
                ev.gen_feats.append(gen)
        ct, cj = (ev.bootstrap_fgd(n_boot=50, seed=3, return_draws=True) for ev in (ev_t, ev_j))
        assert ct == cj
        arms.append(ct)
    assert tfgd.paired_fgd_gap(*arms) == jfgd.paired_fgd_gap(*arms)
    with pytest.raises(ValueError, match="not paired"):
        tfgd.paired_fgd_gap(arms[0], dict(arms[1], seed=4))


def test_fgd_extract_dispatches_by_width():
    gen = torch.Generator().manual_seed(0)
    from talkshow_torch.models.layers import init_weights_
    ae = init_weights_(AE(129, 64, 16), gen)
    ev = tfgd.FGDEvaluator(ae)
    poses = np.random.default_rng(2).standard_normal((1, 16, 165)).astype(np.float32)
    from talkshow_torch.ops.pose import C_INDEX_3D
    with torch.no_grad():
        want = ae.eval().encode(torch.as_tensor(poses[..., C_INDEX_3D]))
    assert torch.equal(ev.extract(poses), want)
    assert torch.equal(ev.extract(poses[..., C_INDEX_3D]), want)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.standard_normal((30, 55, 3)).astype(np.float32)
    pr = rng.standard_normal((3, 30, 55, 3)).astype(np.float32)
    _rel(tm.lvd(torch.as_tensor(gt), torch.as_tensor(pr[0])),
         jm.lvd(jnp.asarray(gt), jnp.asarray(pr[0])), 1e-6)
    for sym in (False, True):
        _rel(tm.batch_lvd(torch.as_tensor(gt), torch.as_tensor(pr), symmetrical=sym),
             jm.batch_lvd(jnp.asarray(gt), jnp.asarray(pr), symmetrical=sym), 1e-6)
    vals_a, vals_b = rng.random(9), rng.random(9)
    assert tm.clip_ci(vals_a) == jm.clip_ci(vals_a)
    assert tm.paired_clip_gap(vals_a, vals_b, seed=2) == jm.paired_clip_gap(vals_a, vals_b, seed=2)
    assert tm.diversity(pr[:, :, 0]) == jm.diversity(pr[:, :, 0])
    joints = [0.3 * rng.standard_normal((40, 55, 3)) for _ in range(2)]
    beats = [np.sort(rng.uniform(0, 1.3, 5)) for _ in range(2)]
    np.testing.assert_array_equal(tm.maac(joints), jm.maac(joints))
    assert tm.beat_consistency(joints, beats) == jm.beat_consistency(joints, beats)


def test_onset_times_match_jax(tmp_path):
    path = str(tmp_path / "beats.wav")
    t = np.arange(int(22050 * 3.0)) / 22050
    x = 0.05 * np.random.default_rng(4).standard_normal(t.shape)
    for k in range(6):   # clicks every 0.5 s on a noise floor, at 22.05 kHz
        s = int((0.25 + 0.5 * k) * 22050)
        x[s:s + 400] += 0.8 * np.sin(2 * np.pi * 880 * t[:400])
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    want = jaudio.onset_times(path)
    got = taudio.onset_times(path, device="cpu")
    assert len(want) >= 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio._slaney_mel_fb(16000, 2048, 128),
                                  jaudio._slaney_mel_fb(16000, 2048, 128))
    # resampled to 16 kHz: the same sinc kernel, f32 sums in another order
    np.testing.assert_allclose(taudio.get_raw_16k(path), jaudio.get_raw_16k(path), atol=1e-6)


def test_legacy2d_is_the_jax_module():
    src_t = open(tl2d.__file__).read()
    src_j = open(jl2d.__file__).read()
    assert src_t.split('"""', 2)[2] == src_j.split('"""', 2)[2]   # the code after the docstring
    rng = np.random.default_rng(5)
    kps = rng.standard_normal((40, 12, 2))
    seq = rng.standard_normal((2, 40, 108))
    assert tl2d.lvd_2d(kps, kps[::-1]) == jl2d.lvd_2d(kps, kps[::-1])
    np.testing.assert_array_equal(tl2d.cvt25(seq), jl2d.cvt25(seq))
    np.testing.assert_array_equal(tl2d.peak_velocity(kps), jl2d.peak_velocity(kps))
    a, b = tl2d.mode_transition_seq(seq), jl2d.mode_transition_seq(seq)
    np.testing.assert_array_equal(a, b)
    assert tl2d.mode_transition_consistency(a, b[:1]) == jl2d.mode_transition_consistency(a, b[:1])


# ---------------------------------------------------------------------------
# the SHOW loader
# ---------------------------------------------------------------------------

def _write_show_clip(root, speaker, vid, name, frames, seed):
    d = os.path.join(root, speaker, vid, "test", name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    data = {"jaw_pose": rng.standard_normal((frames, 3)),
            "leye_pose": rng.standard_normal((frames, 3)),
            "reye_pose": rng.standard_normal((frames, 3)),
            "global_orient": rng.standard_normal((frames, 1, 3)),
            "body_pose_axis": 0.3 * rng.standard_normal((frames, 63)),
            "left_hand_pose": rng.standard_normal((frames, 45)),
            "right_hand_pose": rng.standard_normal((frames, 45)),
            "expression": rng.standard_normal((frames, 100)),
            "betas": rng.standard_normal((1, 300))}
    with open(os.path.join(d, name + ".pkl"), "wb") as f:
        pickle.dump(data, f)
    write_wav(os.path.join(d, name + ".wav"), frames / 30.0, seed=seed)


@pytest.fixture(scope="module")
def show_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("show"))
    _write_show_clip(root, "oliver", "v1", "c1", 70, 0)
    _write_show_clip(root, "oliver", "v1", "c2", 64, 1)
    _write_show_clip(root, "conan", "v2", "c3", 80, 2)
    os.makedirs(os.path.join(root, "conan", "v2", "test", "empty"))
    return root


@pytest.mark.parametrize("feat,six_d", [("mfcc", False), ("raw", False), ("mfcc", True)])
def test_from_root_matches_jax(show_root, monkeypatch, feat, six_d):
    from talkshow_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)   # JAX's jnp get_mfcc
    kw = dict(feat=feat, convert_to_6d=six_d)
    jd = jdata.ShowDataset.from_root(show_root, ["oliver", "conan", "seth"], "test", **kw)
    td = tdata.ShowDataset.from_root(show_root, ["oliver", "conan", "seth"], "test",
                                     device="cpu", **kw)
    assert len(td.clips) == len(jd.clips) == 3
    for a, b in zip(td.clips, jd.clips):
        assert (a.speaker, a.audio_path) == (b.speaker, b.audio_path)
        np.testing.assert_allclose(a.poses, b.poses, atol=1e-5 if six_d else 0)
        np.testing.assert_array_equal(a.expression, b.expression)
        np.testing.assert_array_equal(a.betas, b.betas)
        assert a.aud_feat.shape == b.aud_feat.shape and a.aud_feat.dtype == np.float32
        err = np.abs(a.aud_feat - b.aud_feat).max()
        assert err <= 1e-4 * np.abs(b.aud_feat).max(), err


def test_from_root_cache(show_root, tmp_path, monkeypatch):
    cache = str(tmp_path / "test.pkl")
    td = tdata.ShowDataset.from_root(show_root, ["oliver"], "test", cache_pkl=cache,
                                     device="cpu")
    monkeypatch.setattr(tdata.ShowDataset, "load_clip",
                        staticmethod(lambda *a, **k: (_ for _ in ()).throw(AssertionError)))
    again = tdata.ShowDataset.from_root(show_root, ["oliver"], "test", cache_pkl=cache,
                                        device="cpu")
    assert all(np.array_equal(a.aud_feat, b.aud_feat) for a, b in zip(td.clips, again.clips))
    # a cache the JAX package wrote has the same signature, but its classes are not read
    jcache = str(tmp_path / "jax.pkl")
    from talkshow_tpu import native
    monkeypatch.setattr(native, "available", lambda: False)
    jdata.ShowDataset.from_root(show_root, ["oliver"], "test", cache_pkl=jcache)
    with pytest.raises(AssertionError):
        tdata.ShowDataset.from_root(show_root, ["oliver"], "test", cache_pkl=jcache,
                                    device="cpu")


# ---------------------------------------------------------------------------
# the runners, under JAX's noise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """JAX and port pipelines on one set of toy weights, an AE carried
    across, the 4-vertex rig loaded by both, and the same 3 clips (with
    audio files for beat consistency)."""
    jp, tp = pipeline_pair(0)
    jae = JAE(in_dim=129, num_hiddens=NH)
    ae_vars = jax.jit(jae.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 129)))
    tae = AE(129, 64, NH)
    tae.load_state_dict(convert.convert_ae(jax.tree.map(np.asarray, ae_vars)))
    tmp = tmp_path_factory.mktemp("eval")
    npz = str(tmp / "rig.npz")
    np.savez(npz, **tlbs.build_synthetic_smplx_arrays(verts_per_joint=4))
    rigs = jlbs.load_smplx_npz(npz), tlbs.load_smplx_npz(npz, device="cpu")
    dsj, dst = jdata.synthetic_dataset(3, 120, seed=1), tdata.synthetic_dataset(3, 120, seed=1)
    for i, (a, b) in enumerate(zip(dsj.clips, dst.clips)):
        a.audio_path = b.audio_path = write_wav(str(tmp / f"c{i}.wav"), 4.0, seed=i)
    return dict(jp=jp, tp=tp, jae=jae, ae_vars=ae_vars, tae=tae, rigs=rigs, dsj=dsj, dst=dst)


def _close_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close_metrics(g, w)
        elif isinstance(w, (list, np.ndarray)):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                _rel(a, b)
        else:
            _rel(g, w)


def _capture_tokens(monkeypatch, module, store):
    real = module.generate_conv_poses

    def wrapped(*a, **k):
        out = real(*a, **k)
        store.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(module, "generate_conv_poses", wrapped)


@pytest.mark.parametrize("with_smplx", [False, True], ids=["plain", "smplx"])
def test_eval_body_matches_jax(arms, monkeypatch, with_smplx):
    a = arms
    rj, rt = a["rigs"] if with_smplx else (None, None)
    S, seed = 2, 7
    keys, rng = [], jax.random.PRNGKey(seed)
    for _ in a["dsj"].clips:
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    hs = [(min(c.poses.shape[0], c.aud_feat.shape[0]) // 4) for c in a["dst"].clips]
    noise = lambda ci: jax_noise_from_key(keys[ci], hs[ci], S, K)  # noqa: E731
    tj, tt = [], []
    _capture_tokens(monkeypatch, jrun, tj)
    _capture_tokens(monkeypatch, trun, tt)
    want = jrun.eval_body(a["jp"].body, a["jae"], a["ae_vars"], a["dsj"], num_samples=S,
                          seed=seed, smplx_model=rj)
    counts.clear()
    got = trun.eval_body(a["tp"], a["tae"], a["dst"], num_samples=S, noise=noise,
                         smplx_model=rt)
    assert counts["sample_tokens_plain"] == 3 and not counts["ar_decode"]
    assert len(tt) == len(tj) == 3
    for x, y in zip(tt, tj):
        np.testing.assert_array_equal(x, y)
    _close_metrics(got, want)
    assert ("lvd" in got and "bc" in got) == with_smplx


def test_eval_body_draws_from_a_seeded_generator(arms):
    a = arms
    one = trun.eval_body(a["tp"].body, a["tae"], a["dst"], num_samples=2, seed=3)
    two = trun.eval_body(a["tp"].body, a["tae"], a["dst"], num_samples=2, seed=3)
    assert one == two and one["num_clips"] == 3


def test_eval_vq_capacity_matches_jax(arms):
    a = arms
    body = a["jp"].body
    vq_vars = {"body": body.vq_body_vars, "hand": body.vq_hand_vars}
    states = {"body": body.vq_body_state, "hand": body.vq_hand_state}
    want = jrun.eval_vq_capacity(body.vq_body, body.vq_hand, vq_vars, states, a["dsj"])
    tb = a["tp"].body
    counts.clear()
    got = trun.eval_vq_capacity(tb.vq_body, tb.vq_hand,
                                {"body": tb.vq_body_state, "hand": tb.vq_hand_state}, a["dst"])
    assert counts["nearest_code_plain"] == 6
    _close_metrics(got, want)


def _raw_clips(ds):
    for c in ds.clips:
        c.aud_feat = np.random.default_rng(0).standard_normal(
            (c.poses.shape[0] * 16000 // 30, 1)).astype(np.float32)
    return ds


@pytest.mark.parametrize("with_smplx", [False, True], ids=["plain", "smplx"])
def test_eval_face_matches_jax(arms, with_smplx):
    a = arms
    rj, rt = a["rigs"] if with_smplx else (None, None)
    dsj = _raw_clips(jdata.synthetic_dataset(2, 45, seed=2))
    dst = _raw_clips(tdata.synthetic_dataset(2, 45, seed=2))
    want = jrun.eval_face(a["jp"].face_model, a["jp"].face_vars, dsj, rj)
    counts.clear()
    got = trun.eval_face(a["tp"].face_model, dst, rt)
    assert counts["face_plain"] == 2
    _close_metrics(got, want)
    assert ("face_lvd" in got) == with_smplx
    with pytest.raises(ValueError, match="raw-waveform"):
        trun.eval_face(a["tp"].face_model, tdata.synthetic_dataset(1, 30))


# ---------------------------------------------------------------------------
# the eval CLI
# ---------------------------------------------------------------------------

def _narrow_cli(monkeypatch):
    """The CLI's models at the harness's toy widths (it builds the full
    ones)."""
    from types import SimpleNamespace
    real = Pipeline.create
    monkeypatch.setattr(tcli, "Pipeline", SimpleNamespace(create=lambda seed=0, device="cuda": real(
        seed, device, wav2vec_cfg=Wav2Vec2Config(**TINY), **BODY)))
    monkeypatch.setattr(tcli, "AE", lambda in_dim: AE(in_dim, 64, 16))
    monkeypatch.setattr(tcli, "VQVAE", _vq)


def _vq(in_dim):
    from talkshow_torch.models.vqvae import VQVAE
    return VQVAE(in_dim, 64, BODY["num_hiddens"])   # the toy pipeline's VQs


def test_eval_cli_body_and_face(monkeypatch, capsys):
    _narrow_cli(monkeypatch)
    res = tcli.main(["body", "--synthetic", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert "RANDOM-INIT feature extractor" in err and "NOTE: random weights" in out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(res))
    assert res["num_clips"] == 4 and np.isfinite(res["fgd"]) and "fgd_ci" in res
    res = tcli.main(["face", "--synthetic", "--device", "cpu"])
    assert res["num_clips"] == 2 and np.isfinite(res["jaw_l1"])
    with pytest.raises((RuntimeError, AssertionError)):   # the card by default
        tcli.main(["face", "--synthetic"])


def test_eval_cli_vq_and_ae_checkpoints(monkeypatch, tmp_path, capsys):
    """--vq_ckpt and --ae_ckpt take the train CLI's checkpoints ({'state':
    ...}) or reference .pth files."""
    from talkshow_torch.train.steps import make_body_ae_step, make_body_vq_step
    _narrow_cli(monkeypatch)
    init, _ = make_body_vq_step(_vq(39), _vq(90), code_num=2048)
    state = init(torch.Generator().manual_seed(5), "cpu")
    torch.save({"state": state.state_dict(), "epoch": 0}, tmp_path / "vq.pt")
    res = tcli.main(["vq", "--synthetic", "--device", "cpu", "--vq_ckpt", str(tmp_path / "vq.pt")])
    want = trun.eval_vq_capacity(state.models["body"], state.models["hand"], state.vq,
                                 tdata.synthetic_dataset(num_clips=4, frames=240))
    assert res == want
    init_ae, _ = make_body_ae_step(AE(129, 64, 16))
    ae_state = init_ae(torch.Generator().manual_seed(6), "cpu")
    torch.save({"state": ae_state.state_dict()}, tmp_path / "ae.pt")
    assert tcli.ae_weights(torch.load(tmp_path / "ae.pt", weights_only=True)).keys() == \
        ae_state.model.state_dict().keys()
    ref = tcli._load(os.path.join(REPO, "tests", "fixtures", "golden", "body_ae.pth"))
    assert tcli.ae_weights(ref).keys() == convert.reference_body_ae(ref).keys()
    res = tcli.main(["body", "--synthetic", "--device", "cpu", "--ae_ckpt",
                     str(tmp_path / "ae.pt"), "--vq_ckpt", str(tmp_path / "vq.pt")])
    assert "RANDOM-INIT" not in capsys.readouterr().err and np.isfinite(res["fgd"])


def test_eval_modules_import_no_jax():
    import subprocess
    import sys
    code = ("import sys, talkshow_torch.eval.__main__, talkshow_torch.eval.legacy2d; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'talkshow_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

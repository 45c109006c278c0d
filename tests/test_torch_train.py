"""Training stage 1 of the port (talkshow_torch/train, models/vqvae.py,
config.py, data/dataset.py) against the JAX package on the CPU, at
num_hiddens 64 (16 for the trainer; the CLI builds the config's 1024).

Tolerances: a train-mode VQVAE forward (batch-statistics BatchNorm, EMA
quantizer) agrees with flax within 1e-5 (f32, summed in another order),
indices equal; running statistics within 1e-5, which the unbiased variance
of torch's own BatchNorm update (n / (n - 1) = 1.6 % larger at the 64
positions here) would miss.  The body-VQ step from one converted state, at
lr 1e-3, matches the JAX step after one and after three steps: each step's
change of each parameter within 1e-2 lr of JAX's change (see
_assert_update_close for the elements left out), and every metric,
parameter, BatchNorm statistic, VQ state field and Adam moment within 1e-5.
Config, dataset windows and token grids are equal exactly; a resumed
trainer equals an uninterrupted one bit for bit."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu import config as jconfig
from talkshow_tpu.data import dataset as jdata
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.ops import vq as jvq
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import config as tconfig
from talkshow_torch import convert
from talkshow_torch.data import dataset as tdata
from talkshow_torch.kernels import counts
from talkshow_torch.models import vqvae as tv
from talkshow_torch.models.body import BodyModels, encode_gt_tokens
from talkshow_torch.ops import vq as tvq
from talkshow_torch.train import steps as tsteps
from talkshow_torch.train.__main__ import SYNTHETIC_STEPS
from talkshow_torch.train.trainer import Trainer

torch.set_num_threads(2)
TOL = 1e-5
NH, W, B = 64, 16, 4
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(variables, seed):
    """Perturb every leaf; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _poses(seed, width, batch=B):
    return (0.2 * np.random.default_rng(seed).standard_normal((batch, W, width))).astype(np.float32)


def _tstate(js):
    return tvq.VQState(*(torch.tensor(np.asarray(a)) for a in js))


def _flat(tree, prefix=""):
    """Nested state dict -> {dotted path: leaf}, tensors cloned."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v.clone() if torch.is_tensor(v) else v
    return out


def _close_dict(got: dict, want: dict, tag: str):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().cpu().numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f"{tag} {name}")


# ---------------------------------------------------------------------------
# (a) the VQ-VAE forward, train and eval mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vqvae_forward_matches_flax(train):
    jm = jv.VQVAE(in_dim=39, num_hiddens=NH)
    st = jvq.init_vq_state(jax.random.PRNGKey(1), 256, 64)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W, 39)), st), 2)
    x = _poses(3, 39)
    apply = jax.jit(lambda v, xx, s: jm.apply(v, xx, s, train, mutable=["batch_stats"]))
    (recon, commit, nst, idx), upd = apply(variables, jnp.asarray(x), st)
    tm = tv.VQVAE(39, 64, NH)
    tm.load_state_dict(convert.convert_vqvae(variables))
    tm.train(train)
    counts.clear()
    t_recon, t_commit, t_nst, t_idx = tm(torch.as_tensor(x), _tstate(st))
    assert counts["nearest_code_plain"] == 1
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(t_recon.detach().numpy(), np.asarray(recon), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_commit.item(), float(commit), rtol=TOL, atol=1e-7)
    for a, b in zip(t_nst, nst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    want = convert.convert_vqvae({"params": variables["params"], **upd})
    stats = {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))}
    _close_dict(tm.state_dict(), stats, "batch statistics")
    if train:   # the biased variance moved every running_var off its start
        moved = convert.convert_vqvae(variables)
        assert all(not torch.equal(v, moved[k]) for k, v in stats.items())


# ---------------------------------------------------------------------------
# (b) the body-VQ step from one state, (c) the non-finite skip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """Three JAX body-VQ steps on 165-wide poses; the states (as numpy)
    before and after each, and the metrics."""
    vb, vh = jv.VQVAE(in_dim=39, num_hiddens=NH), jv.VQVAE(in_dim=90, num_hiddens=NH)
    init, step = jsteps.make_body_vq_step(vb, vh, learning_rate=LR)
    state = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(0), window=W)
    batches = [_poses(10 + i, 165) for i in range(3)]
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for b in batches:
        state, m = step(state, {"poses": jnp.asarray(b)})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, batches


def _port_state(jax_state, lr=LR):
    vb, vh = tv.VQVAE(39, 64, NH), tv.VQVAE(90, 64, NH)
    init, step = tsteps.make_body_vq_step(vb, vh, learning_rate=lr)
    state = init(torch.Generator().manual_seed(0), "cpu")
    state.load_converted(convert.from_jax_body_vq_state(jax_state))
    return state, step


def _assert_state_close(state, jax_state, tag):
    want = convert.from_jax_body_vq_state(jax_state)
    assert state.step == want["step"]
    assert state.optimizer.nonfinite_count == want["nonfinite_count"]
    adam = state.optimizer.adam
    for part, model in state.models.items():
        _close_dict(model.state_dict(), want[f"vq_{part}"], f"{tag} {part}")
        for name, a, b in zip(tvq.VQState._fields, state.vq[part], want[f"vq_{part}_state"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{tag} {part} {name}")
        for name, p in model.named_parameters():
            if want["adam_step"] == 0:      # fresh: torch makes its moments lazily
                assert p not in adam.state
                continue
            st = adam.state[p]
            assert int(st["step"]) == want["adam_step"]
            for key in ("exp_avg", "exp_avg_sq"):   # within 1e-5 of the largest moment
                w = want[key][part][name]
                err = (st[key] - w).abs().max().item()
                assert err <= TOL * max(1.0, w.abs().max().item()), (tag, key, name, err)


def _assert_update_close(state, before: dict, jax_before, jax_after, tag):
    """Each parameter's change in the step against JAX's change, within
    1e-2 lr.  Adam divides each element's first moment by the root of its
    second, so an element whose gradients are small beside the rounding of
    their f32 sums moves by up to lr with either sign.  Such elements are
    chosen by JAX's gradient scale sqrt(v_hat) (its debiased second
    moment): a whole leaf at most 1e-5 of the part's largest (zero to
    rounding: a conv bias under batch-statistics BatchNorm), or an element
    below 1e-3 of its leaf's largest.  They are left out and take JAX's
    values, so that the next steps start from comparable states; the rest,
    at least 95 % of each part, are held."""
    w0, w1 = convert.from_jax_body_vq_state(jax_before), convert.from_jax_body_vq_state(jax_after)
    debias = 1 - 0.999 ** w1["adam_step"]
    for part, model in state.models.items():
        scale = {k: (v / debias).sqrt() for k, v in w1["exp_avg_sq"][part].items()}
        top = max(s.max().item() for s in scale.values())
        held = total = 0
        for name, p in model.named_parameters():
            s = scale[name]
            keep = s >= max(1e-3 * s.max().item(), 1e-5 * top)
            want = w1[f"vq_{part}"][name] - w0[f"vq_{part}"][name]
            err = ((p.detach() - before[part][name]) - want).abs()[keep]
            assert not keep.any() or err.max().item() <= 1e-2 * LR, (tag, part, name, err.max())
            with torch.no_grad():
                p[~keep] = w1[f"vq_{part}"][name][~keep]
            held += int(keep.sum())
            total += keep.numel()
        assert held >= 0.95 * total, (tag, part, held, total)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_body_vq_step_matches_jax(jax_run, n_steps):
    states, metrics, batches = jax_run
    state, step = _port_state(states[0])
    _assert_state_close(state, states[0], "start")
    counts.clear()
    for i in range(n_steps):
        before = {part: {k: p.detach().clone() for k, p in model.named_parameters()}
                  for part, model in state.models.items()}
        state, m = step(state, {"poses": torch.as_tensor(batches[i])})
        for k, v in metrics[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        _assert_update_close(state, before, states[i], states[i + 1], f"step {i}")
    assert counts["nearest_code_plain"] == 2 * n_steps
    # the Adam chain's plain twin once a step, and no read back from the device
    assert counts["grad_stats_plain"] == counts["adam_apply_plain"] == n_steps
    assert counts["host_sync"] == 0
    _assert_state_close(state, states[n_steps], f"after {n_steps}")


def test_nan_batch_is_skipped_and_counted(jax_run):
    states, _, batches = jax_run
    state, step = _port_state(states[0], lr=1e-3)
    good = torch.as_tensor(batches[0])[..., :129].contiguous()
    state, m = step(state, {"poses": good})
    assert m["nonfinite_skips"] == 0
    before = _flat(state.state_dict())
    bad = good.clone()
    bad[0, 0, 0] = float("nan")
    state, m = step(state, {"poses": bad})
    assert m["nonfinite_skips"] == 1 and state.step == 2
    after = _flat(state.state_dict())
    assert after.pop("step") == before.pop("step") + 1
    assert after.pop("optimizer.nonfinite_count") == before.pop("optimizer.nonfinite_count") + 1
    assert after.keys() == before.keys()
    for k, v in before.items():   # parameters, statistics, VQ states, Adam: untouched
        assert torch.equal(after[k], v) if torch.is_tensor(v) else after[k] == v, k
    state, m = step(state, {"poses": good})
    assert m["nonfinite_skips"] == 1 and np.isfinite(float(m["body_rec"]))


# ---------------------------------------------------------------------------
# (d) the frozen-VQ token encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [165, 129])
def test_token_encoder_matches_jax(width):
    vb, vh = jv.VQVAE(in_dim=39, num_hiddens=NH), jv.VQVAE(in_dim=90, num_hiddens=NH)
    r = jax.random.split(jax.random.PRNGKey(4), 4)
    sts = {"body": jvq.init_vq_state(r[0], 64, 64), "hand": jvq.init_vq_state(r[1], 64, 64)}
    jvars = {"body": _randomize(vb.init(r[2], jnp.zeros((1, W, 39)), sts["body"]), 5),
             "hand": _randomize(vh.init(r[3], jnp.zeros((1, W, 90)), sts["hand"]), 6)}
    x = _poses(7, width)
    want = np.asarray(jsteps.make_token_encoder(vb, vh, jvars, sts)(jnp.asarray(x)))
    tb, th = tv.VQVAE(39, 64, NH), tv.VQVAE(90, 64, NH)
    tb.load_state_dict(convert.convert_vqvae(jvars["body"]))
    th.load_state_dict(convert.convert_vqvae(jvars["hand"]))
    tsts = {k: _tstate(s) for k, s in sts.items()}
    got = tsteps.make_token_encoder(tb.train(), th, tsts)(torch.as_tensor(x))
    assert got.shape == want.shape == (B, W // 4, 2) and not tb.training
    np.testing.assert_array_equal(got.numpy(), want)
    if width == 129:
        models = BodyModels(tb, th, tsts["body"], tsts["hand"], None, None)
        np.testing.assert_array_equal(encode_gt_tokens(models, torch.as_tensor(x)).numpy(), want)


# ---------------------------------------------------------------------------
# (e) config and data copies
# ---------------------------------------------------------------------------

def _write_config(path, model_name="s2g_body_vq", batch=B, gen_len=W, epochs=1):
    cfg = {
        "dataset_load_mode": "json",
        "Data": {"data_root": "", "pklname": "_t.pkl", "whole_video": False,
                 "pose": {"normalization": False, "convert_to_6d": False,
                          "generate_length": gen_len, "pre_pose_length": 0,
                          "pose_dim": 99, "expression": True},
                 "aud": {"feat_method": "mfcc", "aud_feat_dim": 64}},
        "Model": {"model_type": "body", "model_name": model_name, "composition": True,
                  "code_num": 2048, "bh_model": True, "AudioOpt": "Adam",
                  "encoder_choice": "mfcc", "gan": False},
        "DataLoader": {"batch_size": batch, "num_workers": 0},
        "Train": {"epochs": epochs, "max_gradient_norm": 5,
                  "learning_rate": {"generator_learning_rate": 1e-3,
                                    "discriminator_learning_rate": 1e-4}},
        "Log": {"save_every": 1, "print_every": 5, "name": "t"},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("model_name", ["s2g_body_vq", "s2g_face"])
def test_config_matches_jax(tmp_path, model_name):
    path = _write_config(tmp_path / "c.json", model_name, batch=7, gen_len=32)
    t, j = tconfig.Config.from_reference_json(path), jconfig.Config.from_reference_json(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_json() == j.to_json()
    for name in ("face_config", "body_vq_config", "body_pixel_config", "ls3dcg_config"):
        assert getattr(tconfig, name)().to_json() == getattr(jconfig, name)().to_json()


@pytest.mark.parametrize("shuffle", [True, False])
def test_dataset_batches_match_jax(shuffle):
    t, j = tdata.synthetic_dataset(3, 120, seed=3), jdata.synthetic_dataset(3, 120, seed=3)
    t.generate_length = j.generate_length = 16
    tb = list(t.batches(8, np.random.default_rng(1), shuffle=shuffle))
    jb = list(j.batches(8, np.random.default_rng(1), shuffle=shuffle))
    assert len(tb) == len(jb) > 3
    for a, b in zip(tb, jb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(t.whole_clips(), j.whole_clips()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ts, js = tdata.compute_norm_stats(t), jdata.compute_norm_stats(j)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    p = tb[0]["poses"]
    np.testing.assert_array_equal(tdata.normalize_poses(p, ts), jdata.normalize_poses(p, js))
    np.testing.assert_array_equal(tdata.denormalize_poses(p, ts), jdata.denormalize_poses(p, js))


# ---------------------------------------------------------------------------
# (f) the trainer: an epoch, save, resume; (g) the CLI
# ---------------------------------------------------------------------------

def _trainer(cfg_path, run_dir):
    cfg = tconfig.Config.from_reference_json(cfg_path)
    ds = tdata.synthetic_dataset(num_clips=3, frames=80)
    ds.generate_length = cfg.data.pose.generate_length
    init, step = tsteps.make_body_vq_step(tv.VQVAE(39, 64, 16), tv.VQVAE(90, 64, 16),
                                          cfg.train.generator_learning_rate, code_num=64)
    return Trainer(cfg, ds, init, step, run_dir=str(run_dir), device="cpu",
                   batch_keys=("poses",)).setup()


def test_trainer_resume_equals_uninterrupted(tmp_path):
    cfg = _write_config(tmp_path / "c.json")
    a = _trainer(cfg, tmp_path / "a")
    a.train(epochs=2)
    assert a.global_step >= 10 and len(a.history) == 2
    assert os.path.isfile(tmp_path / "a" / "ckpt-0.pt")
    hist = json.load(open(tmp_path / "a" / "history.json"))
    assert all(np.isfinite(h["body_rec"]) for h in hist)

    b = _trainer(cfg, tmp_path / "b").resume(str(tmp_path / "a" / "ckpt-0.pt"))
    assert b.epoch == 1 and b.global_step == a.global_step // 2
    b.train(epochs=2)
    assert b.global_step == a.global_step
    sa, sb = a.state.state_dict(), b.state.state_dict()
    for part in ("body", "hand"):
        for k, v in sa["models"][part].items():
            assert torch.equal(v, sb["models"][part][k]), k
        for k, v in sa["vq"][part].items():
            assert torch.equal(v, sb["vq"][part][k]), k
    for p, q in zip(a.state.optimizer.params, b.state.optimizer.params):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.state.optimizer.adam.state[p][k],
                               b.state.optimizer.adam.state[q][k])


def test_train_cli_cpu(tmp_path):
    """At full width (1024 hidden), as tests/test_cli_train.py runs
    scripts/train.py; the synthetic dataset holds SYNTHETIC_STEPS batches."""
    cfg = _write_config(tmp_path / "c.json", batch=8)
    run = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "talkshow_torch.train", "--config_file", cfg, "--synthetic",
         "--epochs", "1", "--run_dir", str(run), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))   # two threads, as this process
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done; checkpoints" in proc.stdout
    assert os.path.isfile(run / "ckpt-0.pt") and os.path.isfile(run / "history.json")
    log = open(run / "train.log").read()
    assert "body_rec=" in log and f"step {SYNTHETIC_STEPS} " in log


def test_training_modules_import_no_jax():
    code = ("import sys, talkshow_torch.train.__main__, talkshow_torch.train.trainer, "
            "talkshow_torch.train.steps, talkshow_torch.config, talkshow_torch.data.dataset, "
            "talkshow_torch.kernels.nearest_code, talkshow_torch.convert, talkshow_torch.losses, "
            "talkshow_torch.models.ls3dcg, talkshow_torch.data.preprocess, "
            "talkshow_torch.eval.runners, talkshow_torch.eval.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'optax', 'talkshow_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

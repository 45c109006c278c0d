"""The LS3DCG baseline of the port (talkshow_torch/models/ls3dcg.py, its
train step, its eval runner and CLI stages) and `talkshow_torch/losses.py`
against the JAX package on the CPU, at T = 16-32 frames and batch 2 (the
LS3DCG widths are fixed, 64 ... 1024, as in JAX).

Tolerances: the losses within 1e-6 (the same f32 formula).  The generator
and discriminator forwards, eval and train mode, within 1e-5 of flax's
(f32, summed in another order), their BatchNorm statistics within 1e-5.
The GAN step from one converted state matches JAX's after one and three
steps, at lr 1e-5, with JAX's step run in f64 (its f32 generator
gradients are 2e-3 of their largest off its own f64 ones; see `jax_run`):
metrics within 1e-5 relative (the generator's GAN term reads the updated
discriminator in eval mode, so it reads the conv biases whose Adam update
is rounding noise of up to lr either way, below; at lr 1e-3 that alone
moved the term by 1e-4 relative, at 1e-5 by 5e-7); every gradient within
1e-5 of its model's largest; each step's change of each parameter within
1e-2 lr of JAX's change, leaving out (and setting to JAX's values) the
elements whose gradient is rounding noise (every conv here feeds a
batch-statistics BatchNorm, so its bias has no true gradient and Adam
moves it by up to lr with either sign), as tests/test_torch_train.py
chooses them; parameters, statistics and Adam moments within 1e-5 of
their largest.  `eval_ls3dcg` and `infer_on_audio` within 1e-5 relative
(the MFCC of `infer_on_audio` is fed to both sides as one array: the two
featurizers agree within 1e-4 of its largest magnitude,
tests/test_torch_eval.py)."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu import losses as jloss
from talkshow_tpu.data import dataset as jdata
from talkshow_tpu.eval import runners as jrun
from talkshow_tpu.models import ls3dcg as jls
from talkshow_tpu.models.vqvae import AE as JAE
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert
from talkshow_torch import losses as tloss
from talkshow_torch.data import dataset as tdata
from talkshow_torch.eval import __main__ as ecli
from talkshow_torch.eval import runners as trun
from talkshow_torch.kernels import counts
from talkshow_torch.models import ls3dcg as tls
from talkshow_torch.models.vqvae import AE
from talkshow_torch.train import __main__ as cli
from talkshow_torch.train import steps as tsteps
from test_torch_harness import write_wav

torch.set_num_threads(2)
TOL = 1e-5
W, B = 32, 2
LR = 1e-5
#: the counters of the Adam chain's plain twin (kernels/adam.py), which each optimizer runs
ADAM_TWIN = ("grad_stats_plain", "adam_apply_plain")
KW, GW = 0.9, 1.1


def _randomize(variables, seed):
    """Perturb every leaf; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _close(got, want, tag, scale=1.0, tol=TOL):
    err = (torch.as_tensor(got).detach().cpu() - torch.as_tensor(np.array(want))).abs().max().item()
    assert err <= tol * max(1.0, scale), (tag, err)


def _rel(a, b, tol=TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


# ---------------------------------------------------------------------------
# losses.py
# ---------------------------------------------------------------------------

def _loss_args(name):
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((3, 7, 5)).astype(np.float32) for _ in range(2))
    conf = rng.uniform(0.0, 0.02, (3, 7, 5)).astype(np.float32)
    mu, logvar = (rng.standard_normal((4, 32)).astype(np.float32) for _ in range(2))
    return {"keypoint": ((x, y), {}), "keypoint_conf": ((x, y, conf), {}),
            "kl": ((mu, logvar), {}), "kl_floor": ((mu, 0.1 * logvar), {"tolerance": 20.0,
                                                                      "mul": 1.5}),
            "l2_reg": (([x, y],), {}), "l1": ((x, y), {}), "audio": ((x, y), {}),
            "velocity": ((x, y), {})}[name]


_LOSSES = {"keypoint": "keypoint_loss", "keypoint_conf": "keypoint_loss", "kl": "kl_loss",
           "kl_floor": "kl_loss", "l2_reg": "l2_reg_loss", "l1": "l1_loss",
           "audio": "audio_loss", "velocity": "velocity_loss"}


@pytest.mark.parametrize("case", sorted(_LOSSES))
def test_losses_match_jax(case):
    args, kw = _loss_args(case)
    fn = _LOSSES[case]
    want = float(getattr(jloss, fn)(*jax.tree.map(jnp.asarray, args), **kw))
    got = float(getattr(tloss, fn)(*jax.tree.map(torch.as_tensor, args), **kw))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    if case == "kl":
        with pytest.raises(ValueError, match=r"\(B, D\)"):
            tloss.kl_loss(torch.as_tensor(args[0])[None], torch.as_tensor(args[1])[None])


def test_recon_losses_call_the_loss_library():
    """steps.recon_losses is l1_loss + velocity_loss, bit for bit what its
    inline formula computed."""
    rng = np.random.default_rng(1)
    a, b = (torch.as_tensor(rng.standard_normal((2, 9, 4)).astype(np.float32)) for _ in range(2))
    rec, vel = tsteps.recon_losses(a, b)
    assert torch.equal(rec, torch.mean(torch.abs(a - b)))
    assert torch.equal(vel, torch.mean(torch.abs((a[:, 1:] - a[:, :-1]) - (b[:, 1:] - b[:, :-1]))))


# ---------------------------------------------------------------------------
# the modules against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(5, 11), (11, 5), (8, 8), (3, 22)])
def test_nearest_resize_matches_jax(n_in, n_out):
    x = np.arange(2 * n_in * 3, dtype=np.float32).reshape(2, n_in, 3)
    want = np.asarray(jls.nearest_resize(jnp.asarray(x), n_out))
    assert np.array_equal(tls.nearest_resize(torch.as_tensor(x), n_out).numpy(), want)


@pytest.fixture(scope="module")
def flax_models():
    gen, disc = jls.LS3DCGGenerator(), jls.LS3DCGDiscriminator()
    gv = _randomize(jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.zeros((1, W, 64))), 1)
    dv = _randomize(jax.jit(disc.init)(jax.random.PRNGKey(1), jnp.zeros((1, W, 193))), 2)
    return gen, gv, disc, dv


def _ported(module, variables):
    m = module()
    m.load_state_dict(convert.convert_ls3dcg(jax.tree.map(np.asarray, variables)))
    return m


@pytest.mark.parametrize("which", ["generator", "discriminator"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_module_matches_flax(flax_models, which, train):
    gen, gv, disc, dv = flax_models
    jm, jvars, tcls, width, T = ((gen, gv, tls.LS3DCGGenerator, 64, 29) if which == "generator"
                                 else (disc, dv, tls.LS3DCGDiscriminator, 193, W))
    x = np.random.default_rng(3).standard_normal((B, T, width)).astype(np.float32)
    out, upd = jax.jit(lambda v, xx: jm.apply(v, xx, train, mutable=["batch_stats"]))(
        jvars, jnp.asarray(x))
    tm = _ported(tcls, jvars).train(train)
    got = tm(torch.as_tensor(x))
    want = np.asarray(out)
    assert got.shape == want.shape == ((B, T, 232) if which == "generator" else (B, T // 8, 1))
    _close(got, want, which, np.abs(want).max())
    sd = tm.state_dict()
    stats = convert.convert_ls3dcg({"params": jvars["params"], **jax.tree.map(np.asarray, upd)})
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], v, k, v.abs().max().item())
            assert train != torch.equal(sd[k], convert.convert_ls3dcg(
                jax.tree.map(np.asarray, jvars))[k]), k


# ---------------------------------------------------------------------------
# the GAN step from one converted state
# ---------------------------------------------------------------------------

def _batch(seed, width=165):
    rng = np.random.default_rng(seed)
    return {"poses": (0.2 * rng.standard_normal((B, W, width))).astype(np.float32),
            "expression": (0.3 * rng.standard_normal((B, W, 100))).astype(np.float32),
            "aud_feat": rng.standard_normal((B, W, 64)).astype(np.float32)}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype == np.float64 else np.asarray(a), tree)


@pytest.fixture(scope="module")
def jax_run(flax_models):
    """Three JAX LS3DCG steps from a state with perturbed statistics, then a
    step on a batch with a NaN; the states (numpy, f32) and metrics.  The
    JAX step runs in f64 from the f32 state: in f32 its generator gradients
    are 2e-3 of their largest off its own f64 values, where the port's f32
    is within 3e-6 of them (ROADMAP.md Queue 3, PR 10)."""
    gen, _, disc, _ = flax_models
    init, step = jsteps.make_ls3dcg_step(gen, disc, learning_rate=LR, keypoint_w=KW, gan_w=GW)
    state = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(4), window=W)
    state = _f32(state._replace(g_stats=_randomize(state.g_stats, 5),
                                d_stats=_randomize(state.d_stats, 6)))
    batches = [_batch(10 + i, 165 if i != 1 else 129) for i in range(3)]
    bad = dict(batches[0], aud_feat=batches[0]["aud_feat"].copy())
    bad["aud_feat"][0, 0, 0] = np.nan
    states, metrics = [state], []
    with jax.enable_x64(True):
        state = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                             if a.dtype == np.float32 else jnp.asarray(a), state)
        for b in batches + [bad]:
            state, m = step(state, {k: jnp.asarray(v, jnp.float64) for k, v in b.items()})
            states.append(_f32(state))
            metrics.append({k: float(v) for k, v in m.items()})
    return dict(states=states[:4], metrics=metrics[:3], batches=batches, bad=bad,
                bad_skips=int(metrics[3]["nonfinite_skips"]))


def _port_state(jax_state):
    init, step = tsteps.make_ls3dcg_step(tls.LS3DCGGenerator(), tls.LS3DCGDiscriminator(),
                                         LR, KW, GW)
    state = init(torch.Generator().manual_seed(0), "cpu")
    return state.load_converted(convert.from_jax_ls3dcg_state(jax_state)), step


def _assert_state_close(state, jax_state, tag):
    want = convert.from_jax_ls3dcg_state(jax_state)
    assert state.step == want["step"]
    for part, model in state.models.items():
        sd, adam = model.state_dict(), want["adam"][part]
        top = max(v.abs().max().item() for v in want[part].values())
        for name, w in want[part].items():
            _close(sd[name], w, f"{tag} {part} {name}", top)
        opt = state.optimizers[part]
        assert opt.nonfinite_count == adam["nonfinite_count"]
        for name, p in model.named_parameters():
            if adam["adam_step"] == 0:
                assert p not in opt.adam.state
                continue
            st = opt.adam.state[p]
            assert int(st["step"]) == adam["adam_step"]
            for key in ("exp_avg", "exp_avg_sq"):
                w = adam[key][part][name]
                _close(st[key], w, f"{tag} {part} {key} {name}", w.abs().max().item())


def _assert_update_close(state, before, jax_before, jax_after, tag):
    """Gradients: each model's, as the port's backward left them, within
    1e-5 of its largest |g| of JAX's, recovered from Adam's first moments
    (g = (mu_t - 0.9 mu_t-1) / 0.1).  Updates: each parameter's change within
    1e-2 lr of JAX's (plus the f32 spacing of the parameter: JAX's f64 result
    is rounded to f32), leaving out (and setting to JAX's values) the elements
    whose gradient scale, JAX's debiased sqrt(v_hat), is a whole leaf at most
    1e-5 of the model's largest or an element below 1e-3 of its leaf's
    largest (Adam moves those by about lr sign(g), the sign of rounding);
    at least 90 % of each model is held."""
    w0, w1 = convert.from_jax_ls3dcg_state(jax_before), convert.from_jax_ls3dcg_state(jax_after)
    for part, model in state.models.items():
        a0, a1 = w0["adam"][part], w1["adam"][part]
        grads = {k: (v - 0.9 * a0["exp_avg"][part][k]) / 0.1 if a0["adam_step"] else v / 0.1
                 for k, v in a1["exp_avg"][part].items()}
        gmax = max(g.abs().max().item() for g in grads.values())
        for name, p in model.named_parameters():
            _close(p.grad, grads[name], f"{tag} {part} grad {name}", tol=1e-5 * gmax)
        debias = 1 - 0.999 ** a1["adam_step"]
        scale = {k: (v / debias).sqrt() for k, v in a1["exp_avg_sq"][part].items()}
        top = max(s.max().item() for s in scale.values())
        held = total = 0
        for name, p in model.named_parameters():
            s = scale[name]
            keep = s >= max(1e-3 * s.max().item(), 1e-5 * top)
            want = w1[part][name] - w0[part][name]
            # JAX's f64 result is rounded to f32: its spacing, 2 eps |p|, on top
            tol = 1e-2 * LR + 2 * torch.finfo(torch.float32).eps * w1[part][name].abs()
            err = ((p.detach() - before[part][name]) - want).abs() - tol
            assert not keep.any() or err[keep].max().item() <= 0, (tag, part, name, err.max())
            with torch.no_grad():
                p[~keep] = w1[part][name][~keep]
            held += int(keep.sum())
            total += keep.numel()
        assert held >= 0.9 * total, (tag, part, held, total)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_ls3dcg_step_matches_jax(jax_run, n_steps):
    states, metrics = jax_run["states"], jax_run["metrics"]
    state, step = _port_state(states[0])
    _assert_state_close(state, states[0], "start")
    counts.clear()
    for i in range(n_steps):
        before = {part: {k: p.detach().clone() for k, p in m.named_parameters()}
                  for part, m in state.models.items()}
        state, m = step(state, {k: torch.as_tensor(v) for k, v in jax_run["batches"][i].items()})
        assert m.keys() == metrics[i].keys()
        for k, v in metrics[i].items():
            _rel(m[k], v)
        _assert_update_close(state, before, states[i], states[i + 1], f"step {i}")
    # no kernel; the Adam chain's plain twin once a model a step, and no host read
    assert counts["grad_stats_plain"] == counts["adam_apply_plain"] == 2 * n_steps
    assert not any(v for k, v in counts.items() if k not in ADAM_TWIN)
    _assert_state_close(state, states[n_steps], f"after {n_steps}")


def test_nonfinite_ls3dcg_step_is_skipped(jax_run):
    state, step = _port_state(jax_run["states"][3])
    before = {k: v.clone() for part in state.models.values()
              for k, v in part.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for o in state.optimizers.values() for p, s in o.adam.state.items()}
    state, m = step(state, {k: torch.as_tensor(v) for k, v in jax_run["bad"].items()})
    assert m["nonfinite_skips"] == jax_run["bad_skips"] == 2 and state.step == 4
    after = {k: v for part in state.models.values() for k, v in part.state_dict().items()}
    assert all(torch.equal(after[k], v) for k, v in before.items())
    for o in state.optimizers.values():
        for p, s in o.adam.state.items():
            assert all(torch.equal(v, moments[id(p)][k]) for k, v in s.items())


# ---------------------------------------------------------------------------
# eval_ls3dcg and infer_on_audio
# ---------------------------------------------------------------------------

def _close_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _close_metrics(got[k], w)
        elif isinstance(w, (list, np.ndarray)):
            assert len(got[k]) == len(w), k
            for a, b in zip(got[k], w):
                _rel(a, b)
        else:
            _rel(got[k], w)


class _Jitted:
    """A flax module whose `apply` runs under jit (JAX's runner calls it
    once per clip; the same numbers as the module's own apply)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames="method")


def test_eval_ls3dcg_matches_jax(flax_models):
    gen, gv, _, _ = flax_models
    jae = JAE(in_dim=129, num_hiddens=16)
    ae_vars = jax.jit(jae.init)(jax.random.PRNGKey(7), jnp.zeros((1, 16, 129)))
    tae = AE(129, 64, 16)
    tae.load_state_dict(convert.convert_ae(jax.tree.map(np.asarray, ae_vars)))
    dsj, dst = jdata.synthetic_dataset(3, 40, seed=2), tdata.synthetic_dataset(3, 40, seed=2)
    want = jrun.eval_ls3dcg(_Jitted(gen), gv, _Jitted(jae), ae_vars, dsj)
    got = trun.eval_ls3dcg(_ported(tls.LS3DCGGenerator, gv), tae, dst)
    assert got["num_clips"] == 3 and "fgd_ci" in got and "body_l1_ci" in got
    _close_metrics(got, want)
    short = tdata.synthetic_dataset(1, 1, seed=2)
    short.clips[0].poses = short.clips[0].poses[:7]
    with pytest.raises(ValueError, match="no usable clips"):
        trun.eval_ls3dcg(_ported(tls.LS3DCGGenerator, gv), tae, short)


def test_infer_on_audio_matches_jax(flax_models, tmp_path, monkeypatch):
    from talkshow_tpu.ops import audio as jaudio
    from talkshow_torch.ops import audio as taudio
    gen, gv, _, _ = flax_models
    wav = write_wav(str(tmp_path / "s.wav"), 1.5, seed=3)
    tgen = _ported(tls.LS3DCGGenerator, gv)
    free = tls.infer_on_audio(tgen, wav, num_samples=2)      # the port's own MFCC
    assert free.shape == (2, 45, 265) and np.isfinite(free).all()
    feat = np.random.default_rng(8).standard_normal((45, 64)).astype(np.float32)
    monkeypatch.setattr(jaudio, "get_mfcc", lambda *a, **k: feat)
    monkeypatch.setattr(taudio, "get_mfcc", lambda *a, device="cuda", **k:
                        torch.as_tensor(feat, device=device))
    rng = np.random.default_rng(9)
    stats = (0.1 * rng.standard_normal(165).astype(np.float32),
             rng.uniform(0.5, 1.5, 165).astype(np.float32))
    for norm in (None, stats):
        want = jls.infer_on_audio(gen, gv, wav, num_samples=2, norm_stats=norm)
        got = tls.infer_on_audio(tgen, wav, num_samples=2, norm_stats=norm)
        assert got.shape == want.shape == (2, 45, 265)
        _close(got, want, "infer_on_audio", np.abs(want).max())


# ---------------------------------------------------------------------------
# the CLI stages: s2g_LS3DCG training and `python -m talkshow_torch.eval ls3dcg`
# ---------------------------------------------------------------------------

def _write_config(path, batch=2, gen_len=16):
    cfg = {"Data": {"pose": {"generate_length": gen_len}},
           "Model": {"model_name": "s2g_LS3DCG"},
           "DataLoader": {"batch_size": batch},
           "Train": {"epochs": 2, "learning_rate": {"generator_learning_rate": 1e-4},
                     "weights": {"keypoint_loss_weight": KW, "gan_loss_weight": GW}},
           "Log": {"save_every": 1, "print_every": 5, "name": "t"}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_ls3dcg_cli_stage_resumes_and_evaluates(tmp_path, monkeypatch, capsys):
    """main() for s2g_LS3DCG on the synthetic windows: finite logs, the
    config's loss weights, no kernel; ckpt-0 + epoch 2 equals the
    uninterrupted 2 epochs bit for bit; the eval CLI's `ls3dcg` runner reads
    the checkpoint."""
    cfg = _write_config(tmp_path / "c.json")
    base = ["--config_file", cfg, "--synthetic", "--device", "cpu"]
    counts.clear()
    a = cli.main(base + ["--epochs", "2", "--run_dir", str(tmp_path / "a")])
    assert a.global_step >= 2 * cli.SYNTHETIC_STEPS
    assert not any(v for k, v in counts.items() if k not in ADAM_TWIN + ("host_sync",))
    hist = json.load(open(tmp_path / "a" / "history.json"))
    assert all(np.isfinite(v) for h in hist for v in h.values())
    log = open(tmp_path / "a" / "train.log").read()
    assert "dis=" in log and "gen=" in log and "hand_loss=" in log
    b = cli.main(base + ["--epochs", "2", "--run_dir", str(tmp_path / "b"),
                         "--resume", str(tmp_path / "a" / "ckpt-0.pt")])
    assert b.global_step == a.global_step
    for part in ("gen", "disc"):
        sa, sb = a.state.models[part].state_dict(), b.state.models[part].state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items()), part
    monkeypatch.setattr(ecli, "AE", lambda in_dim: AE(in_dim, 64, 16))
    res = ecli.main(["ls3dcg", "--synthetic", "--device", "cpu", "--ls3dcg_ckpt",
                     str(tmp_path / "a" / "ckpt-1.pt")])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == json.loads(json.dumps(res))
    assert res["num_clips"] == 4 and np.isfinite(res["fgd"]) and "RANDOM-INIT" in out.err

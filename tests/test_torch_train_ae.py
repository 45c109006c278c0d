"""The body AE, the FGD feature net (talkshow_torch/models/vqvae.AE,
convert.convert_ae / reference_body_ae / from_jax_body_ae_state,
train/steps.make_body_ae_step and the CLI's s2g_body_ae stage), against
the JAX package on the CPU at num_hiddens 64.

Tolerances: the AE forward and encode from `convert.from_jax` within 1e-5
of the output's largest magnitude of flax's (f32, summed in another order
through 19 convolutions on perturbed weights, outputs of O(50)), in eval
and in train mode (batch statistics; the running statistics too).  The golden
`body_ae.pth` through `reference_body_ae` meets expected.npz's `ae_rec` /
`ae_feat` at the JAX golden test's 2e-4.  The body-AE step from one
converted JAX state, after one and after three steps: losses within 1e-5
relative, and every parameter, BatchNorm statistic and Adam moment within
1e-5 of its leaf's largest magnitude, except the elements Adam moves by
rounding noise (`_assert_update_close`, as tests/test_torch_train.py
holds the body-VQ step)."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert
from talkshow_torch.models import vqvae as tv
from talkshow_torch.train import steps as tsteps
from test_torch_reference_ckpt import _load, _t, golden  # noqa: F401 (a fixture)
from test_torch_train import _randomize, _write_config

torch.set_num_threads(2)
TOL = 1e-5
NH, W, B = 64, 16, 4
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poses(seed, width=165, batch=B):
    return (0.2 * np.random.default_rng(seed).standard_normal((batch, W, width))).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ae_forward_and_encode_match_flax(train):
    jm = jv.AE(in_dim=129, num_hiddens=NH)
    variables = _randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, W, 129))), 1)
    x = _poses(2, 129)
    (recon, upd) = jax.jit(lambda v, xx: jm.apply(v, xx, train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    feat = jm.apply(variables, jnp.asarray(x), method=jv.AE.encode)
    weights = convert.from_jax({}, _empty_body(), ae_vars=jax.tree.map(np.asarray, variables))
    tm = tv.AE(129, 64, NH)
    tm.load_state_dict(weights["ae"])
    with torch.no_grad():
        got = tm.train(train)(torch.as_tensor(x))
        _close_rel(got, torch.as_tensor(np.array(recon)), "recon")
        if train:
            want = convert.convert_ae({"params": variables["params"], **upd})
            for k, v in want.items():
                if k.endswith(("running_mean", "running_var")):
                    _close_rel(tm.state_dict()[k], v, k)
        else:
            _close_rel(tm.encode(torch.as_tensor(x)), torch.as_tensor(np.array(feat)), "feat")


def _empty_body():
    """`from_jax`'s body half, empty: this test carries the AE alone."""
    from talkshow_tpu.ops.vq import VQState
    st = VQState(*(np.zeros((1, 1)),) * 2, np.zeros(1), np.zeros((), np.int32))
    return {k: {} for k in ("vq_body_vars", "vq_hand_vars", "audio_enc_vars", "prior_vars")} | {
        "vq_body_state": st, "vq_hand_state": st}


def test_golden_body_ae_fixture(golden):  # noqa: F811
    meta, exp = golden
    ckpt = _load("body_ae.pth")
    sd = convert.reference_body_ae(ckpt)
    assert not any(k.startswith(("decoder.frame_enc", "decoder.gru_sl")) for k in sd)
    model = tv.AE(129, 64, meta["vq_hid"])
    model.load_state_dict(sd)
    model.eval()
    # the wrapper state and the bare AE state dict convert alike
    for other in (ckpt["generator"], ckpt["generator"]["g"]):
        alt = convert.reference_body_ae(other)
        assert alt.keys() == sd.keys() and all(torch.equal(alt[k], sd[k]) for k in sd)
    x = _t(exp["ae_in"]).transpose(1, 2)
    with torch.no_grad():
        rec = model(x)
        feat = model.encode(x)
    np.testing.assert_allclose(rec.transpose(1, 2).numpy(), exp["ae_rec"], atol=2e-4)
    np.testing.assert_allclose(feat.transpose(1, 2).numpy(), exp["ae_feat"], atol=2e-4)


# ---------------------------------------------------------------------------
# the body-AE step from one state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """Three JAX body-AE steps (lr 1e-3) on 165-wide poses: the states (as
    numpy) before and after each, and the metrics."""
    ae = jv.AE(in_dim=129, num_hiddens=NH)
    init, step = jsteps.make_body_ae_step(ae, LR)
    state = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(0), window=W)
    batches = [_poses(10 + i) for i in range(3)]
    states, metrics = [jax.tree.map(np.asarray, state)], []
    for b in batches:
        state, m = step(state, {"poses": jnp.asarray(b)})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, batches


def _port_state(jax_state):
    init, step = tsteps.make_body_ae_step(tv.AE(129, 64, NH), LR)
    state = init(torch.Generator().manual_seed(0), "cpu")
    state.load_converted(convert.from_jax_body_ae_state(jax_state))
    return state, step


def _close_rel(got: torch.Tensor, want: torch.Tensor, tag: str):
    err = (got.detach() - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), (tag, err)


def _assert_state_close(state, jax_state, tag):
    want = convert.from_jax_body_ae_state(jax_state)
    assert state.step == want["step"]
    assert state.optimizer.nonfinite_count == want["nonfinite_count"]
    sd = state.model.state_dict()
    for k, v in want["ae"].items():
        _close_rel(sd[k], v, f"{tag} {k}")
    for name, p in state.model.named_parameters():
        if want["adam_step"] == 0:
            assert p not in state.optimizer.adam.state
            continue
        st = state.optimizer.adam.state[p]
        assert int(st["step"]) == want["adam_step"]
        for key in ("exp_avg", "exp_avg_sq"):
            _close_rel(st[key], want[key]["ae"][name], f"{tag} {key} {name}")


def _assert_update_close(state, before: dict, jax_before, jax_after, tag):
    """Each parameter's change against JAX's, within 1e-2 lr, leaving out
    the elements whose gradient is rounding noise, chosen by JAX's debiased
    second moment (a leaf at most 1e-5 of the largest, e.g. a conv bias
    under batch-statistics BatchNorm, or an element below 1e-3 of its
    leaf's largest): Adam moves those by up to lr with either sign.  They
    take JAX's values; at least 95 % of the elements are held."""
    w0, w1 = convert.from_jax_body_ae_state(jax_before), convert.from_jax_body_ae_state(jax_after)
    debias = 1 - 0.999 ** w1["adam_step"]
    scale = {k: (v / debias).sqrt() for k, v in w1["exp_avg_sq"]["ae"].items()}
    top = max(s.max().item() for s in scale.values())
    held = total = 0
    for name, p in state.model.named_parameters():
        s = scale[name]
        keep = s >= max(1e-3 * s.max().item(), 1e-5 * top)
        want = w1["ae"][name] - w0["ae"][name]
        err = ((p.detach() - before[name]) - want).abs()[keep]
        assert not keep.any() or err.max().item() <= 1e-2 * LR, (tag, name, err.max())
        with torch.no_grad():
            p[~keep] = w1["ae"][name][~keep]
        held += int(keep.sum())
        total += keep.numel()
    assert held >= 0.95 * total, (tag, held, total)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_body_ae_step_matches_jax(jax_run, n_steps):
    states, metrics, batches = jax_run
    state, step = _port_state(states[0])
    _assert_state_close(state, states[0], "start")
    for i in range(n_steps):
        before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        state, m = step(state, {"poses": torch.as_tensor(batches[i])})
        for k, v in metrics[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        _assert_update_close(state, before, states[i], states[i + 1], f"step {i}")
    _assert_state_close(state, states[n_steps], f"after {n_steps}")


def test_nonfinite_batch_keeps_parameters_and_statistics(jax_run):
    states, _, batches = jax_run
    state, step = _port_state(states[0])
    state, m = step(state, {"poses": torch.as_tensor(batches[0])})
    assert m["nonfinite_skips"] == 0
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {n: {k: v.clone() for k, v in state.optimizer.adam.state[p].items()}
               for n, p in state.model.named_parameters()}
    bad = torch.as_tensor(batches[1]).clone()
    bad[1, 3, 40] = float("inf")   # a conv channel (0-17 are dropped)
    state, m = step(state, {"poses": bad})
    assert m["nonfinite_skips"] == 1 and state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for n, p in state.model.named_parameters():
        for k, v in state.optimizer.adam.state[p].items():
            assert torch.equal(v, moments[n][k]), (n, k)


def test_body_ae_cli_stage(tmp_path):
    """python -m talkshow_torch.train for s2g_body_ae at the config's 1024
    hidden on the synthetic windows; its checkpoint loads into the eval
    CLI's AE."""
    from talkshow_torch.eval.__main__ import ae_weights
    from talkshow_torch.train.__main__ import SYNTHETIC_STEPS
    cfg = _write_config(tmp_path / "ae.json", "s2g_body_ae", batch=4)
    run = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "talkshow_torch.train", "--config_file", cfg, "--synthetic",
         "--epochs", "1", "--run_dir", str(run), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = open(run / "train.log").read()
    assert "rec_loss=" in log and "velocity_loss=" in log and f"step {SYNTHETIC_STEPS} " in log
    ckpt = torch.load(run / "ckpt-0.pt", map_location="cpu", weights_only=True)
    ae = tv.AE(129)
    ae.load_state_dict(ae_weights(ckpt))
    assert all(torch.isfinite(v).all() for v in ae.state_dict().values() if v.is_floating_point())

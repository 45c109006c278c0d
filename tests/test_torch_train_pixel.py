"""Training stage 2 of the port (the body-pixel step, its optimizer chain,
the audio dropout, the trainer's token cache and the CLI stage) against
the JAX package on the CPU, at toy widths: VQ-VAEs of 16 hidden and 64
codes, an audio encoder of 32, a prior of dim 16 x 3 layers, window 16
(4 token rows), batch 4.

Tolerances: losses and gradient norms within 1e-5 relative; BatchNorm
statistics, Adam moments (of their largest) and parameters within 1e-5
(the same f32 math summed in another order).  Each step's change of a
parameter is held within 1e-2 lr of JAX's: Adam divides a gradient by its
own scale, so an element whose gradient is rounding noise (a conv bias
under batch-statistics BatchNorm, whose true gradient is zero) moves by up
to lr with either sign on either side; those elements, chosen by JAX's
gradient scale as tests/test_torch_train.py chooses them, take JAX's
values.  The optimizer chain alone (clip, Adam, SGD with momentum) is held
to optax within 1e-6 over several steps, both clip branches included.
Token grids, masks and cached batches are equal exactly.  The same step
tests hold the vertical-only prior (bh_model=False) to JAX's, and the CLI
trains it; the CLI's codebook sizing (code_num codes of width
vq_embedding_dim in both stages) is pinned on a non-default config."""
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import linen as nn

from talkshow_tpu.models import pixelcnn as jp
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.ops import vq as jvq
from talkshow_tpu.train import steps as jsteps
from talkshow_tpu.utils import skip_nonfinite_updates
from benchmark import faults
from talkshow_torch import config as tconfig
from talkshow_torch import convert
from talkshow_torch.data import dataset as tdata
from talkshow_torch.kernels import counts
from talkshow_torch.models import pixelcnn as tp
from talkshow_torch.models import vqvae as tv
from talkshow_torch.ops import vq as tvq
from talkshow_torch.train import __main__ as cli
from talkshow_torch.train import optim as topt
from talkshow_torch.train import steps as tsteps
from talkshow_torch.train.graph import replayable
from talkshow_torch.train.trainer import Trainer, step_seed

torch.set_num_threads(2)
TOL = 1e-5
NH, CODES, AUD, DIM, LAYERS = 16, 64, 32, 16, 3
W, B = 16, 4
H = W // 4
LR = 1e-3
#: below the first step's gradient norm (~3), so that step takes the clip branch
MAX_NORM = 2.0


def _randomize(variables, seed):
    """Perturb every leaf; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _tstate(js):
    return tvq.VQState(*(torch.tensor(np.asarray(a)) for a in js))


def _batch(seed, width=165):
    rng = np.random.default_rng(seed)
    return {"poses": (0.2 * rng.standard_normal((B, W, width))).astype(np.float32),
            "aud_feat": rng.standard_normal((B, W, 64)).astype(np.float32),
            "speaker": np.asarray([0, 1, 2, 3], np.int32)[:B]}


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the JAX side: frozen VQs, the prior, three steps, the masks they drew
# ---------------------------------------------------------------------------

def _jax_models(bh_model=True):
    vb, vh = jv.VQVAE(in_dim=39, num_hiddens=NH), jv.VQVAE(in_dim=90, num_hiddens=NH)
    r = jax.random.split(jax.random.PRNGKey(1), 4)
    sts = {"body": jvq.init_vq_state(r[0], CODES, 64), "hand": jvq.init_vq_state(r[1], CODES, 64)}
    jvars = {"body": _randomize(jax.jit(vb.init)(r[2], jnp.zeros((1, W, 39)), sts["body"]), 5),
             "hand": _randomize(jax.jit(vh.init)(r[3], jnp.zeros((1, W, 90)), sts["hand"]), 6)}
    prior = jp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD,
                             bh_model=bh_model)
    return vb, vh, jvars, sts, prior, jv.AudioEncoder(num_hiddens=AUD)


def jax_aud_keep(prior, prior_params, key, batch=B, rows=H):
    """The audio dropout's keep mask that `prior.apply(..., rngs={'dropout':
    key})` draws, (batch, rows) bool: the submodule called alone with the
    same key, as flax derives it from the module path and call count."""
    keep = prior.apply({"params": prior_params}, rngs={"dropout": key},
                       method=lambda m: m.aud_dropout(jnp.ones((batch, rows, 1, 1)),
                                                      deterministic=False))
    return np.asarray(keep[..., 0, 0]) != 0


def _jax_steps(bh_model):
    """Three JAX body-pixel steps; the states (numpy) before and after each,
    the metrics, the batches, the keys' keep masks and the models."""
    vb, vh, jvars, sts, prior, audio = _jax_models(bh_model)
    init, step = jsteps.make_body_pixel_step(prior, audio, vb, vh, jvars, sts,
                                             learning_rate=LR, max_grad_norm=MAX_NORM)
    state = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(2), window=W)
    batches = [_batch(10 + i, 165 if i % 2 == 0 else 129) for i in range(3)]
    states, metrics, keeps = [jax.tree.map(np.asarray, state)], [], []
    for i, b in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        keeps.append(jax_aud_keep(prior, state.params["prior"], key))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    tokens = np.asarray(jsteps.make_token_encoder(vb, vh, jvars, sts)(jnp.asarray(batches[0]["poses"])))
    return dict(states=states, metrics=metrics, batches=batches, keeps=keeps, jvars=jvars,
                sts=sts, prior=prior, audio=audio, tokens=tokens, bh_model=bh_model)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_steps(True)


@pytest.fixture(scope="module")
def jax_run_vertical():
    """`jax_run` with the vertical-only prior (bh_model=False)."""
    return _jax_steps(False)


def _port(jvars, sts, lr=LR, state=None, bh_model=True):
    """The port's step and a state loaded from a JAX PixelState."""
    tb, th = tv.VQVAE(39, 64, NH), tv.VQVAE(90, 64, NH)
    tb.load_state_dict(convert.convert_vqvae(jvars["body"]))
    th.load_state_dict(convert.convert_vqvae(jvars["hand"]))
    states = {k: _tstate(s) for k, s in sts.items()}
    prior = tp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD,
                             bh_model=bh_model)
    init, step = tsteps.make_body_pixel_step(prior, tv.AudioEncoder(num_hiddens=AUD), tb, th,
                                             states, lr, MAX_NORM)
    st = init(torch.Generator().manual_seed(0), "cpu")
    if state is not None:
        st.load_converted(convert.from_jax_pixel_state(state, bh_model))
    return st, step, (tb, th, states)


def _close(got, want, tag, scale=None):
    tol = TOL * (1.0 if scale is None else max(1.0, scale))
    err = (got.detach().cpu() - want).abs().max().item() if got.numel() else 0.0
    assert err <= tol, (tag, err, tol)


def _assert_state_close(state, jax_state, tag, bh_model=True):
    want = convert.from_jax_pixel_state(jax_state, bh_model)
    assert state.step == want["step"]
    assert state.optimizer.nonfinite_count == want["nonfinite_count"]
    adam = state.optimizer.adam
    for part, model in state.models.items():
        sd = model.state_dict()
        top = max(v.abs().max().item() for v in want[part].values())
        for name, w in want[part].items():
            _close(sd[name], w, f"{tag} {part} {name}", top)
        for name, p in model.named_parameters():
            if want["adam_step"] == 0:
                assert p not in adam.state
                continue
            st = adam.state[p]
            assert int(st["step"]) == want["adam_step"]
            for key in ("exp_avg", "exp_avg_sq"):
                w = want[key][part][name]
                _close(st[key], w, f"{tag} {part} {key} {name}", w.abs().max().item())


def _assert_update_close(state, before, jax_before, jax_after, tag, bh_model=True):
    """Each parameter's change in the step within 1e-2 lr of JAX's change,
    leaving out (and setting to JAX's values) the elements whose gradient
    scale, JAX's debiased sqrt(v_hat), is a whole leaf at most 1e-5 of the
    part's largest or an element below 1e-3 of its leaf's largest; at least
    95 % of each part is held."""
    w0, w1 = (convert.from_jax_pixel_state(s, bh_model) for s in (jax_before, jax_after))
    debias = 1 - 0.999 ** w1["adam_step"]
    for part, model in state.models.items():
        scale = {k: (v / debias).sqrt() for k, v in w1["exp_avg_sq"][part].items()}
        top = max(s.max().item() for s in scale.values())
        held = total = 0
        for name, p in model.named_parameters():
            s = scale[name]
            keep = s >= max(1e-3 * s.max().item(), 1e-5 * top)
            want = w1[part][name] - w0[part][name]
            err = ((p.detach() - before[part][name]) - want).abs()[keep]
            assert not keep.any() or err.max().item() <= 1e-2 * LR, (tag, part, name, err.max())
            with torch.no_grad():
                p[~keep] = w1[part][name][~keep]
            held += int(keep.sum())
            total += keep.numel()
        assert held >= 0.95 * total, (tag, part, held, total)


# ---------------------------------------------------------------------------
# (a) the optimizer chain against optax
# ---------------------------------------------------------------------------

def _grad_trees(seed, n, scale):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    return [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
            for _ in range(n)]


@pytest.mark.parametrize("skip", [False, True], ids=["finite", "skipped"])
@pytest.mark.parametrize("scale", [0.05, 3.0], ids=["below_max_norm", "clipped"])
@pytest.mark.parametrize("inner", ["adam", "sgd"])
def test_optimizer_chain_matches_optax(inner, scale, skip):
    """skip_nonfinite(chain(clip_by_global_norm(1), adam | sgd(momentum
    0.9))) over four steps, the second one's gradient holding a NaN when
    `skip`: parameters and moments within 1e-6, the skip counted as JAX
    counts it, both chains' global norm its, and one host read a step of
    the SGD chain (its flag and norm together), none of the Adam chain's."""
    grads = _grad_trees(3, 4, scale)
    if skip:
        grads[1][2][1, 2, 3] = np.nan
    params0 = [g * 0 + 0.5 for g in grads[0]]
    tx_inner = (optax.adam(1e-2, b1=0.9, b2=0.999) if inner == "adam"
                else optax.sgd(1e-2, momentum=0.9))
    tx = skip_nonfinite_updates(optax.chain(optax.clip_by_global_norm(1.0), tx_inner))
    jparams = [jnp.asarray(p) for p in params0]
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params0]
    opt = (topt.SkipNonfiniteAdam(tparams, 1e-2, max_norm=1.0) if inner == "adam"
           else topt.SkipNonfiniteSGD(tparams, 1e-2, 0.9, max_norm=1.0))
    norms = []
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        norms.append(float(optax.global_norm(jg)))
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, x in zip(tparams, g):
            p.grad = torch.tensor(x)
        finite = np.isfinite(norms[-1])
        syncs = counts["host_sync"]
        norm = opt.grad_norm()
        stepped = opt.step(norm)
        assert counts["host_sync"] - syncs == (1 if inner == "sgd" else 0)
        if finite:
            assert abs(float(norm) - norms[-1]) <= 1e-6 * norms[-1]
        assert bool(stepped) == finite
        for p, q in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=1e-6)
    assert opt.nonfinite_count == int(jstate["nonfinite_count"]) == int(skip)
    norms = [n for n in norms if np.isfinite(n)]
    assert (min(norms) > 1.0) if scale > 1 else (max(norms) < 1.0)
    inner_state = jstate["inner"][1]
    if inner == "sgd":     # the momentum buffer is optax's trace
        for p, t in zip(tparams, inner_state[0].trace):
            np.testing.assert_allclose(opt.inner.state[p]["momentum_buffer"].numpy(),
                                       np.asarray(t), rtol=0, atol=1e-6)
    else:                  # the moments and the count are optax's
        for p, mu, nu in zip(tparams, inner_state[0].mu, inner_state[0].nu):
            st = opt.adam.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu), rtol=0, atol=1e-6)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(nu), rtol=0,
                                       atol=1e-6)
            assert st["step"] is opt.step_count
        assert int(opt.step_count) == int(inner_state[0].count) == 4 - int(skip)


def test_step_is_defined_once_for_the_frozen_fault():
    """`SkipNonfinite.step` alone defines the step, so the benchmark's
    `frozen` fault (which patches it to return True) freezes every Adam
    step: the parameters and moments stay as they were."""
    assert "step" not in topt.SkipNonfiniteAdam.__dict__
    assert "step" not in topt.SkipNonfiniteSGD.__dict__
    p = torch.nn.Parameter(torch.ones(5))
    opt = topt.SkipNonfiniteAdam([p], 1e-2, max_norm=1.0)
    p.grad = torch.full((5,), 0.3)
    undo = faults.plant("frozen")
    try:
        assert opt.step() is True
    finally:
        undo()
    assert torch.equal(p.detach(), torch.ones(5)) and p not in opt.adam.state
    assert bool(opt.step()) and not torch.equal(p.detach(), torch.ones(5))


def _adam_pair():
    """Two Adam chains over equal leaves of ragged sizes."""
    shapes = [(5, 3), (7,), (2, 3, 4)]
    make = lambda: [torch.nn.Parameter(torch.full(s, 0.5)) for s in shapes]  # noqa: E731
    a, b = make(), make()
    return (a, topt.SkipNonfiniteAdam(a, 1e-2, max_norm=1.0),
            b, topt.SkipNonfiniteAdam(b, 1e-2, max_norm=1.0))


def _adam_steps(params, opt, grads):
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        opt.step()


@pytest.mark.parametrize("via", ["state_dict", "load_adam"])
def test_adam_state_round_trips_the_device_counts(via):
    """The device step count and the skip count survive state_dict ->
    load_state_dict (through torch.save) and `_load_adam` (a converted JAX
    state's layout): the loaded chain reads the same counts and steps on
    from them as the original does."""
    grads = _grad_trees(4, 5, 0.5)
    grads[1][0][0, 0] = np.inf
    a, opt_a, b, opt_b = _adam_pair()
    _adam_steps(a, opt_a, grads[:3])
    assert opt_a.nonfinite_count == 1 and int(opt_a.step_count) == 2
    if via == "state_dict":
        buf = io.BytesIO()
        torch.save(opt_a.state_dict(), buf)
        buf.seek(0)
        opt_b.load_state_dict(torch.load(buf))
    else:
        model = torch.nn.ParameterList(b)
        name = dict(model.named_parameters())
        weights = {"nonfinite_count": 1, "adam_step": 2,
                   "exp_avg": {"m": {n: opt_a.adam.state[a[int(n)]]["exp_avg"] for n in name}},
                   "exp_avg_sq": {"m": {n: opt_a.adam.state[a[int(n)]]["exp_avg_sq"]
                                        for n in name}}}
        tsteps._load_adam(opt_b, {"m": model}, weights)
    with torch.no_grad():
        for p, q in zip(b, a):
            p.copy_(q)
    assert opt_b.nonfinite_count == 1
    _adam_steps(a, opt_a, grads[3:])
    _adam_steps(b, opt_b, grads[3:])
    assert int(opt_b.step_count) == int(opt_a.step_count) == 4
    assert opt_b.nonfinite_count == 1
    for p, q in zip(b, a):
        assert torch.equal(p, q)
        assert opt_b.adam.state[p]["step"] is opt_b.step_count
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_b.adam.state[p][k], opt_a.adam.state[q][k])


def test_clip_is_optax_formula_not_clip_grad_norm():
    """g / norm * max_norm, not g * (max_norm / (norm + 1e-6)): on a
    gradient of norm 3 the two differ, and the port's equals optax's bit
    for bit on the CPU."""
    g = np.asarray([3.0, 0.0, 0.0, 1e-3], np.float32)
    want = np.asarray(optax.clip_by_global_norm(1.0).update([jnp.asarray(g)], None)[0][0])
    got = [torch.tensor(g)]
    topt.clip_by_global_norm_(got, 1.0)
    torch_clip = torch.nn.Parameter(torch.zeros(4))
    torch_clip.grad = torch.tensor(g)
    torch.nn.utils.clip_grad_norm_([torch_clip], 1.0)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert not np.array_equal(torch_clip.grad.numpy(), want)


# ---------------------------------------------------------------------------
# (b) the audio dropout and the train-mode audio encoder
# ---------------------------------------------------------------------------

def test_aud_dropout_mask_recovered_and_applied(jax_run):
    """JAX's recovered keep mask reproduces JAX's train forward bit for bit
    (the mask injected through an interceptor in place of aud_dropout);
    the port's forward with it agrees within 1e-5; masks are (B, H) at
    rate 0.1, one value per row over both columns and every channel."""
    prior, state = jax_run["prior"], jax_run["states"][0]
    params = state.params["prior"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, CODES, (B, H, 2)).astype(np.int32)
    label = np.asarray([0, 1, 2, 3], np.int32)
    audio = rng.standard_normal((B, H, AUD)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    train = np.asarray(prior.apply({"params": params}, tokens, label, audio, True,
                                   rngs={"dropout": key}))
    keep = jax_aud_keep(prior, params, key)
    assert keep.shape == (B, H) and keep.dtype == bool

    def inject(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, nn.Dropout) and ctx.method_name == "__call__":
            return jnp.asarray(keep, jnp.float32)[..., None, None] / 0.9
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(inject):
        again = np.asarray(prior.apply({"params": params}, tokens, label, audio, True,
                                       rngs={"dropout": jax.random.PRNGKey(8)}))
    np.testing.assert_array_equal(again, train)
    model = tp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD)
    model.load_state_dict(convert.convert_pixelcnn({"params": params}))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens).long(), torch.as_tensor(label).long(),
                    torch.as_tensor(audio), torch.as_tensor(keep)).numpy()
        evl = model(torch.as_tensor(tokens).long(), torch.as_tensor(label).long(),
                    torch.as_tensor(audio)).numpy()
    np.testing.assert_allclose(got, train, rtol=TOL, atol=TOL)
    if not keep.all():
        assert np.abs(evl - train).max() > 1e-3      # the mask changed the logits
    draws = torch.cat([tp.draw_aud_keep(64, 88, torch.Generator().manual_seed(s), "cpu")
                       for s in range(8)])
    assert draws.shape == (512, 88) and abs(1 - draws.float().mean().item() - 0.1) < 0.01
    big = jax_aud_keep(prior, params, jax.random.PRNGKey(9), 512, 88)
    assert abs(1 - big.mean() - 0.1) < 0.01


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_audio_encoder_follows_train_mode(train):
    """The port's AudioEncoder normalises with batch statistics and updates
    its running ones the flax way in .train(), and reads them in .eval(),
    as flax's `train` flag selects."""
    audio = jv.AudioEncoder(num_hiddens=AUD)
    variables = _randomize(jax.jit(audio.init)(jax.random.PRNGKey(0), jnp.zeros((1, W, 64))), 1)
    x = np.random.default_rng(2).standard_normal((B, W, 64)).astype(np.float32)
    out, upd = audio.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    model = tv.AudioEncoder(num_hiddens=AUD)
    model.load_state_dict(convert.convert_audio_encoder(variables))
    model.train(train)
    got = model(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    want = convert.convert_audio_encoder({"params": variables["params"], **upd})
    sd = model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], v, k)
            assert train != torch.equal(v, convert.convert_audio_encoder(variables)[k]), k


# ---------------------------------------------------------------------------
# (c) the step from one converted state, (d) tokens given, (e) the skip
# ---------------------------------------------------------------------------

def _steps_match_jax(run, n_steps):
    states, metrics, bh = run["states"], run["metrics"], run["bh_model"]
    state, step, _ = _port(run["jvars"], run["sts"], state=states[0], bh_model=bh)
    _assert_state_close(state, states[0], "start", bh)
    counts.clear()
    for i in range(n_steps):
        before = {part: {k: p.detach().clone() for k, p in m.named_parameters()}
                  for part, m in state.models.items()}
        batch = dict(_torch_batch(run["batches"][i]), aud_keep=torch.as_tensor(run["keeps"][i]))
        state, m = step(state, batch)
        for k, v in metrics[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        _assert_update_close(state, before, states[i], states[i + 1], f"step {i}", bh)
    assert metrics[0]["grad"] > MAX_NORM     # the first step took the clip branch
    assert counts["nearest_code_plain"] == 2 * n_steps
    # the Adam chain's plain twin once a step, and no read back from the device
    assert counts["grad_stats_plain"] == counts["adam_apply_plain"] == n_steps
    assert counts["host_sync"] == 0
    # on the CPU every step runs eagerly: nothing captured, nothing replayed
    assert counts["train_graph_capture"] == counts["train_graph_replay"] == 0
    assert not state.graph.captured
    _assert_state_close(state, states[n_steps], f"after {n_steps}", bh)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_body_pixel_step_matches_jax(jax_run, n_steps):
    _steps_match_jax(jax_run, n_steps)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_vertical_only_pixel_step_matches_jax(jax_run_vertical, n_steps):
    """The bh_model=False prior's step from one JAX state: its parameters
    (no fusion_h, no horizontal stack), the tolerances of the test above."""
    assert "fusion_h" not in jax_run_vertical["states"][0].params["prior"]
    _steps_match_jax(jax_run_vertical, n_steps)


@pytest.mark.parametrize("device, mesh, hook, replays", [
    ("cuda", None, None, True), ("cuda", "mesh", None, False), ("cpu", None, None, False),
    ("cuda", None, "parameter", False), ("cuda", None, "module", False)])
def test_step_replays_only_on_a_card_without_a_mesh(device, mesh, hook, replays):
    """The body-pixel step replays a CUDA graph on a CUDA device with no
    mesh and no hook; on the CPU, on a mesh (collectives) and with a hook on
    a parameter or a module (Python a replay would skip) it runs eagerly."""
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))
    if hook == "parameter":
        model[0].weight.register_hook(lambda g: g)
    elif hook == "module":
        model[0].register_forward_hook(lambda mod, args, out: out)
    assert replayable(torch.device(device), mesh, [model]) is replays


def test_tokens_given_equal_frozen_encode(jax_run):
    """The trainer's cached tokens stand in for the frozen encode: the same
    grid as JAX's encoder, and a step from one state with them equals the
    step that encodes, bit for bit, without a nearest-code search."""
    batch = dict(_torch_batch(jax_run["batches"][0]),
                 aud_keep=torch.as_tensor(jax_run["keeps"][0]))
    a, step, (tb, th, states) = _port(jax_run["jvars"], jax_run["sts"],
                                      state=jax_run["states"][0])
    b, step_b, _ = _port(jax_run["jvars"], jax_run["sts"], state=jax_run["states"][0])
    tokens = tsteps.make_token_encoder(tb, th, states)(batch["poses"])
    np.testing.assert_array_equal(tokens.numpy(), jax_run["tokens"])
    _, ma = step(a, batch)
    counts.clear()
    _, mb = step_b(b, dict(batch, tokens=tokens, poses=None))
    assert counts["nearest_code_plain"] == 0
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    for part in a.models:
        for (k, v), w in zip(a.models[part].state_dict().items(),
                             b.models[part].state_dict().values()):
            assert torch.equal(v, w), (part, k)


@pytest.mark.parametrize("bad", ["nan_input", "inf_gradient"])
def test_nonfinite_pixel_step_is_skipped(jax_run, bad):
    """A NaN in the audio features (every gradient non-finite) or one inf
    in one leaf's gradient: the step changes no parameter, BatchNorm
    statistic, moment or step count, counts the skip, reads nothing back
    from the device, and the next step from there is JAX's from the same
    state (batch 1 and its keep mask, JAX's second step)."""
    state, step, _ = _port(jax_run["jvars"], jax_run["sts"], state=jax_run["states"][1])
    gen = torch.Generator().manual_seed(1)
    batch = _torch_batch(jax_run["batches"][0])
    before = {part: {k: v.clone() for k, v in m.state_dict().items()}
              for part, m in state.models.items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.adam.state.items()}
    hook = None
    if bad == "nan_input":
        batch = dict(batch, aud_feat=batch["aud_feat"].clone())
        batch["aud_feat"][0, 0, 0] = float("nan")
    else:
        leaf = next(state.models["prior"].parameters())
        hook = leaf.register_hook(lambda g: g.flatten().index_put(
            (torch.tensor([0]),), torch.tensor(float("inf"))).view_as(g))
    counts.clear()
    state, m = step(state, batch, gen)
    assert counts["host_sync"] == 0 and counts["adam_apply_plain"] == 1
    if hook is not None:
        hook.remove()
    assert m["nonfinite_skips"] == 1 and state.step == 2
    for part, model in state.models.items():   # parameters and BatchNorm statistics
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[part][k]), (part, k)
    for p, s in state.optimizer.adam.state.items():   # moments and Adam's step count
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k
    state.step = 1
    params = {part: {k: p.detach().clone() for k, p in m.named_parameters()}
              for part, m in state.models.items()}
    good = dict(_torch_batch(jax_run["batches"][1]), aud_keep=torch.as_tensor(jax_run["keeps"][1]))
    state, m = step(state, good)
    assert m["nonfinite_skips"] == 1 and np.isfinite(float(m["ce_loss"]))
    for k, v in jax_run["metrics"][1].items():
        if k != "nonfinite_skips":     # JAX's state skipped nothing
            np.testing.assert_allclose(float(m[k]), v, rtol=TOL, atol=1e-7, err_msg=k)
    _assert_update_close(state, params, jax_run["states"][1], jax_run["states"][2], "after skip")


# ---------------------------------------------------------------------------
# (f) the trainer's token cache, (g) the CLI stage
# ---------------------------------------------------------------------------

def _pixel_trainer(jax_run, run_dir, cached: bool, tmp_cfg):
    cfg = tconfig.Config.from_reference_json(tmp_cfg)
    ds = tdata.synthetic_dataset(num_clips=2, frames=90)
    ds.generate_length = W
    state, step, (tb, th, states) = _port(jax_run["jvars"], jax_run["sts"])
    enc = tsteps.make_token_encoder(tb, th, states) if cached else None
    encodes = []

    def counted(poses):
        encodes.append(poses.shape[0])
        return enc(poses)

    tr = Trainer(cfg, ds, lambda g, d: state, step, run_dir=str(run_dir), device="cpu",
                 batch_keys=("poses", "aud_feat", "speaker"), needs_rng=True,
                 token_encoder=counted if cached else None).setup()
    return tr, encodes


def _write_config(path, model_name, batch=B, gen_len=W, **model):
    cfg = {"Data": {"pose": {"generate_length": gen_len}},
           "Model": {"model_name": model_name, "code_num": CODES, **model},
           "DataLoader": {"batch_size": batch},
           "Train": {"epochs": 2, "learning_rate": {"generator_learning_rate": 1e-3}},
           "Log": {"save_every": 1, "print_every": 3, "name": "t"}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_trainer_token_cache(jax_run, tmp_path):
    """Epoch 1 encodes every batch once, then every window the dataset can
    give that no batch brought (`fill_cache`, batches of the step's size);
    epoch 2 encodes nothing; the cached run ends bit-equal to the uncached
    one (the same per-step generators), and its cache holds the encode's
    own grids."""
    cfg = _write_config(tmp_path / "c.json", "s2g_body_pixel", batch=2)
    tr, encodes = _pixel_trainer(jax_run, tmp_path / "a", True, cfg)
    tr.train(epochs=1)
    n_batches = tr.global_step
    keys = tr.dataset.window_keys()
    fills = -(-(len(keys) - 2 * n_batches) // 2)
    assert n_batches >= 4 and len(encodes) == n_batches + fills and set(encodes) == {2}
    assert set(tr._token_cache) == set(keys) and len(keys) > 2 * n_batches
    tr.train(epochs=2)
    assert len(encodes) == n_batches + fills         # epoch 2: every batch hit
    un, none = _pixel_trainer(jax_run, tmp_path / "b", False, cfg)
    un.train(epochs=2)
    assert not none and un.global_step == tr.global_step
    for part in tr.state.models:
        for (k, v), w in zip(tr.state.models[part].state_dict().items(),
                             un.state.models[part].state_dict().values()):
            assert torch.equal(v, w), (part, k)
    _, _, (tb, th, states) = _port(jax_run["jvars"], jax_run["sts"])
    enc = tsteps.make_token_encoder(tb, th, states)
    keys = sorted(tr._token_cache)
    poses = np.stack([tr.dataset.clips[c].poses[s:s + W] for c, s in keys])
    np.testing.assert_array_equal(np.stack([tr._token_cache[k] for k in keys]),
                                  enc(torch.as_tensor(poses)).numpy())


def test_step_generator_is_seeded_by_step():
    a, b = step_seed(0, 5), step_seed(0, 6)
    assert a != b and a == step_seed(0, 5) and step_seed(1, 5) != a


def _narrow(monkeypatch):
    """Build the CLI's models at toy widths (the config sets none of them)."""
    monkeypatch.setattr(cli, "VQVAE", lambda width, emb, nh: tv.VQVAE(width, emb, NH))
    monkeypatch.setattr(cli, "GatedPixelCNN", lambda **kw: tp.GatedPixelCNN(
        input_dim=kw["input_dim"], dim=DIM, n_layers=LAYERS, n_classes=kw["n_classes"],
        audio_channels=AUD, bh_model=kw["bh_model"]))
    monkeypatch.setattr(cli, "AudioEncoder", lambda num_hiddens: tv.AudioEncoder(
        num_hiddens=AUD))


def test_pixel_cli_takes_the_stage1_checkpoint(tmp_path, monkeypatch):
    """`python -m talkshow_torch.train`'s main for s2g_body_pixel on a
    checkpoint of its own s2g_body_vq run: finite logs, the frozen VQs
    loaded from the file, the cache filled; without --vq_ckpt it raises."""
    _narrow(monkeypatch)
    vq_cfg = _write_config(tmp_path / "vq.json", "s2g_body_vq")
    px_cfg = _write_config(tmp_path / "px.json", "s2g_body_pixel")
    base = ["--synthetic", "--epochs", "1", "--device", "cpu"]
    stage1 = cli.main(["--config_file", vq_cfg, "--run_dir", str(tmp_path / "vq")] + base)
    ckpt = str(tmp_path / "vq" / "ckpt-0.pt")
    with pytest.raises(SystemExit, match="--vq_ckpt"):
        cli.main(["--config_file", px_cfg, "--run_dir", str(tmp_path / "px0")] + base)
    counts.clear()
    tr = cli.main(["--config_file", px_cfg, "--run_dir", str(tmp_path / "px"),
                   "--vq_ckpt", ckpt] + base)
    assert tr.global_step >= cli.SYNTHETIC_STEPS and tr.needs_rng
    keys = tr.dataset.window_keys()          # epoch 1: every batch missed, then the fill
    fills = -(-(len(keys) - B * tr.global_step) // B)
    assert counts["nearest_code_plain"] == 2 * (tr.global_step + fills)
    assert set(tr._token_cache) == set(keys)
    hist = json.load(open(tmp_path / "px" / "history.json"))
    assert all(np.isfinite(v) for h in hist for v in h.values())
    assert "ce_loss=" in open(tmp_path / "px" / "train.log").read()
    frozen = tr.token_encoder
    poses = torch.as_tensor(next(tr.dataset.batches(B, np.random.default_rng(0)))["poses"])
    want = tsteps.make_token_encoder(stage1.state.models["body"], stage1.state.models["hand"],
                                     stage1.state.vq)(poses)
    assert torch.equal(frozen(poses), want)
    counts.clear()
    nc = cli.main(["--config_file", px_cfg, "--run_dir", str(tmp_path / "px1"),
                   "--vq_ckpt", ckpt, "--no_token_cache"] + base)
    assert nc.token_encoder is None and counts["nearest_code_plain"] == 2 * nc.global_step
    cfg = json.load(open(px_cfg))
    cfg["Model"]["vq_path"] = ckpt          # Model.vq_path stands in for --vq_ckpt
    with open(px_cfg, "w") as f:
        json.dump(cfg, f)
    assert cli.main(["--config_file", px_cfg, "--run_dir", str(tmp_path / "px2"),
                     "--epochs", "0", "--synthetic", "--device", "cpu"]).global_step == 0


def test_pixel_cli_trains_the_vertical_only_prior(tmp_path, monkeypatch):
    """Model.bh_model false: the CLI's stage 2 builds and trains the
    vertical-only prior (finite logs, the cache filled), and its
    checkpoint loads into such a prior."""
    _narrow(monkeypatch)
    base = ["--synthetic", "--epochs", "1", "--device", "cpu"]
    cli.main(["--config_file", _write_config(tmp_path / "vq.json", "s2g_body_vq"),
              "--run_dir", str(tmp_path / "vq")] + base)
    px_cfg = _write_config(tmp_path / "px.json", "s2g_body_pixel", bh_model=False)
    tr = cli.main(["--config_file", px_cfg, "--run_dir", str(tmp_path / "px"),
                   "--vq_ckpt", str(tmp_path / "vq" / "ckpt-0.pt")] + base)
    prior = tr.state.models["prior"]
    assert not prior.bh_model and not hasattr(prior, "fusion_h")
    assert tr.global_step >= cli.SYNTHETIC_STEPS and set(tr._token_cache) == set(
        tr.dataset.window_keys())
    hist = json.load(open(tmp_path / "px" / "history.json"))
    assert all(np.isfinite(v) for h in hist for v in h.values())
    sd = torch.load(tmp_path / "px" / "ckpt-0.pt", weights_only=True)["state"]
    tp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD,
                     bh_model=False).load_state_dict(sd["models"]["prior"])


def test_cli_codebook_sizes_follow_the_config(tmp_path, monkeypatch):
    """The port's codebook rule on a non-default config (code_num 64 ≠ 2048,
    vq_embedding_dim 16 ≠ 64): stage 1's codebooks are (64, 16), its VQ-VAEs
    emit width 16, and stage 2's frozen VQs and the prior's 64 logits take
    those sizes.  (JAX's stage 1 would build 2048 codes and its stage 2
    width-64 VQ-VAEs; see the CLI's docstring.)  The reference JSON has no
    key for the width, in either package's reader, so the config object is
    set after it is read."""
    _narrow(monkeypatch)
    read = tconfig.Config.from_reference_json

    def with_width(path):
        cfg = read(path)
        cfg.model.vq_embedding_dim = 16
        return cfg

    monkeypatch.setattr(cli.Config, "from_reference_json", staticmethod(with_width))
    base = ["--synthetic", "--epochs", "1", "--device", "cpu"]
    sizes = dict(code_num=64)
    vq = cli.main(["--config_file", _write_config(tmp_path / "vq.json", "s2g_body_vq", **sizes),
                   "--run_dir", str(tmp_path / "vq")] + base)
    assert all(s.embeddings.shape == (64, 16) for s in vq.state.vq.values())
    assert all(m.embedding_dim == 16 for m in vq.state.models.values())
    cfg = with_width(_write_config(tmp_path / "px.json", "s2g_body_pixel", **sizes))
    vb, vh, states = cli.frozen_vqs(cfg, str(tmp_path / "vq" / "ckpt-0.pt"))
    assert vb.embedding_dim == vh.embedding_dim == 16
    assert all(s.embeddings.shape == (64, 16) for s in states.values())
    tr = cli.main(["--config_file", str(tmp_path / "px.json"), "--run_dir",
                   str(tmp_path / "px"), "--vq_ckpt", str(tmp_path / "vq" / "ckpt-0.pt")] + base)
    prior = tr.state.models["prior"]
    assert prior.input_dim == 64 and prior.out_logits.out_features == 64
    grids = np.stack(list(tr._token_cache.values()))
    assert grids.min() >= 0 and grids.max() < 64

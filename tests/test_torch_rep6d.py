"""The 6-D pose variant (convert_to_6d) of the port against the JAX package
on the CPU: the body-VQ step, the frozen token encode and the body-pixel
step with `rep6d=True` (poses (T, 330), C_INDEX_6D, 78 body / 180 hand
channels), `generate_conv_poses` at 258 channels, the train CLI's 6-D
stages, and K1's host-side launch plan at the 6-D prior's shape (dim 512,
10 layers), whose decode runs on the card only
(tests/test_torch_kernels_cuda.py).  Toy widths as
tests/test_torch_train.py and tests/test_torch_train_pixel.py: VQ-VAEs of
16 hidden, a prior of dim 16 x 3 layers over 64 codes, window 16, batch 4.

Tolerances are those two files' (their helpers hold the states): metrics
within 1e-5 relative; each step's change of a parameter within 1e-2 lr of
JAX's, rounding-noise elements left out; parameters, statistics, VQ states
and Adam moments within 1e-5.  Token grids equal exactly; conv poses within
1e-5 (the same f32 decoders)."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import test_torch_train as t1
import test_torch_train_pixel as t2
from talkshow_tpu.models import body as jbody
from talkshow_tpu.models import pixelcnn as jp
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.ops import vq as jvq
from talkshow_tpu.train import steps as jsteps
from talkshow_tpu.utils import skip_nonfinite_updates
from talkshow_torch import convert
from talkshow_torch.kernels import ar_decode, counts
from talkshow_torch.models import body as tbody
from talkshow_torch.models import pixelcnn as tp
from talkshow_torch.models import vqvae as tv
from talkshow_torch.ops import vq as tvq
from talkshow_torch.ops.pose import C_INDEX_6D
from talkshow_torch.train import __main__ as cli
from talkshow_torch.train import steps as tsteps
from test_torch_harness import jax_noise_from_key

torch.set_num_threads(2)
NH, CODES, AUD, DIM, LAYERS = 16, 64, 32, 16, 3
W, B = 16, 4
H = W // 4
LR = t1.LR
assert LR == t2.LR


def _poses(seed, width=330):
    return (0.2 * np.random.default_rng(seed).standard_normal((B, W, width))).astype(np.float32)


def _tstate(js):
    return tvq.VQState(*(torch.tensor(np.asarray(a)) for a in js))


def _cast(tree, dtype):
    """Every float leaf of a pytree (numpy or JAX) as `dtype` (numpy)."""
    return jax.tree.map(lambda a: np.asarray(a, dtype) if np.issubdtype(np.asarray(a).dtype,
                                                                        np.floating)
                        else np.asarray(a), tree)


# ---------------------------------------------------------------------------
# stage 1: the body-VQ step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vqs():
    """JAX 6-D VQ-VAEs (78 / 180 channels) with perturbed variables and
    64-code VQ states, their inits under jit."""
    vb, vh = jv.VQVAE(in_dim=78, num_hiddens=NH), jv.VQVAE(in_dim=180, num_hiddens=NH)
    r = jax.random.split(jax.random.PRNGKey(1), 4)
    sts = {"body": jvq.init_vq_state(r[0], CODES, 64), "hand": jvq.init_vq_state(r[1], CODES, 64)}
    jvars = {"body": t1._randomize(jax.jit(vb.init)(r[2], jnp.zeros((1, W, 78)), sts["body"]), 5),
             "hand": t1._randomize(jax.jit(vh.init)(r[3], jnp.zeros((1, W, 180)), sts["hand"]),
                                   6)}
    return vb, vh, jvars, sts


def _adam(*clip):
    """The steps' optimizer: skip_nonfinite([clip, ] adam) (steps.py:49, :159)."""
    adam = optax.adam(LR, b1=0.9, b2=0.999)
    return skip_nonfinite_updates(optax.chain(*clip, adam) if clip else adam)


@pytest.fixture(scope="module")
def vq_run(jax_vqs):
    """Three JAX 6-D body-VQ steps from an f32 state; the states (f32) and
    metrics.  The steps run op by op (jit disabled: the same operations
    without the ~45 s compile of the whole step) and in f64, the reference
    the port's f32 is held to (JAX's own f32 steps put the first Adam moment
    of a BatchNorm scale 1.1e-5 of its largest off its f64 value)."""
    vb, vh, jvars, sts = jax_vqs
    _, step = jsteps.make_body_vq_step(vb, vh, learning_rate=LR, rep6d=True)
    # the state init_state makes (its optimizer chain), on jax_vqs' variables
    params = {k: v["params"] for k, v in jvars.items()}
    state = _cast(jsteps.BodyVQState(params, {k: v["batch_stats"] for k, v in jvars.items()},
                                     sts, _adam().init(params), jnp.zeros((), jnp.int32)),
                  np.float32)
    batches = [_poses(10 + i, 330 if i != 1 else 258) for i in range(3)]
    states, metrics = [state], []
    with jax.enable_x64(True), jax.disable_jit():
        state = _cast(state, np.float64)
        for b in batches:
            state, m = step(state, {"poses": jnp.asarray(b, jnp.float64)})
            states.append(_cast(state, np.float32))
            metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, batches


@pytest.mark.parametrize("n_steps", [1, 3])
def test_body_vq_step_6d_matches_jax(vq_run, n_steps):
    states, metrics, batches = vq_run
    init, step = tsteps.make_body_vq_step(tv.VQVAE(78, 64, NH), tv.VQVAE(180, 64, NH),
                                          learning_rate=LR, code_num=CODES, rep6d=True)
    state = init(torch.Generator().manual_seed(0), "cpu")
    state.load_converted(convert.from_jax_body_vq_state(states[0]))
    counts.clear()
    for i in range(n_steps):
        before = {part: {k: p.detach().clone() for k, p in model.named_parameters()}
                  for part, model in state.models.items()}
        state, m = step(state, {"poses": torch.as_tensor(batches[i])})
        for k, v in metrics[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        t1._assert_update_close(state, before, states[i], states[i + 1], f"step {i}")
    assert counts["nearest_code_plain"] == 2 * n_steps
    _assert_vq_state_close(state, states[n_steps], f"after {n_steps}")


def _assert_vq_state_close(state, jax_state, tag):
    """tests/test_torch_train.py's check against the f64 reference:
    parameters, statistics and VQ states within 1e-5 of their largest, Adam
    moments within 5e-5 of theirs: the moments are the gradients themselves
    (and their squares), and the port's f32 gradient of the encoder's
    input layers, behind three levels of batch-statistics BatchNorm, is up
    to 1.6e-5 of its largest off the f64 value at the 6-D widths."""
    want = convert.from_jax_body_vq_state(jax_state)
    assert state.step == want["step"]
    assert state.optimizer.nonfinite_count == want["nonfinite_count"]
    adam = state.optimizer.adam
    for part, model in state.models.items():
        t1._close_dict(model.state_dict(), want[f"vq_{part}"], f"{tag} {part}")
        for name, a, b in zip(tvq.VQState._fields, state.vq[part], want[f"vq_{part}_state"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{tag} {part} {name}")
        for name, p in model.named_parameters():
            st = adam.state[p]
            assert int(st["step"]) == want["adam_step"]
            for key, tol in (("exp_avg", 5e-5), ("exp_avg_sq", 5e-5)):
                w = want[key][part][name]
                err = (st[key] - w).abs().max().item()
                assert err <= tol * max(1.0, w.abs().max().item()), (tag, key, name, err)


@pytest.mark.parametrize("width", [330, 258])
def test_token_encoder_6d_matches_jax(jax_vqs, width):
    vb, vh, jvars, sts = jax_vqs
    x = _poses(7, width)
    want = np.asarray(jsteps.make_token_encoder(vb, vh, jvars, sts, rep6d=True)(jnp.asarray(x)))
    tb, th = tv.VQVAE(78, 64, NH), tv.VQVAE(180, 64, NH)
    tb.load_state_dict(convert.convert_vqvae(jvars["body"]))
    th.load_state_dict(convert.convert_vqvae(jvars["hand"]))
    got = tsteps.make_token_encoder(tb, th, {k: _tstate(s) for k, s in sts.items()},
                                    rep6d=True)(torch.as_tensor(x))
    assert got.shape == (B, H, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    conv = tsteps.conv_channels(torch.as_tensor(x), rep6d=True)
    assert conv.shape[-1] == 258 and (width == 258 or torch.equal(conv, torch.as_tensor(
        x[..., C_INDEX_6D])))


# ---------------------------------------------------------------------------
# stage 2: the body-pixel step on 6-D tokens; generate_conv_poses at 258
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pixel_run(jax_vqs):
    vb, vh, jvars, sts = jax_vqs
    prior = jp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD)
    audio = jv.AudioEncoder(num_hiddens=AUD)
    _, step = jsteps.make_body_pixel_step(prior, audio, vb, vh, jvars, sts, learning_rate=LR,
                                          max_grad_norm=t2.MAX_NORM, rep6d=True)
    # the state init_state makes (its optimizer chain)
    r = jax.random.split(jax.random.PRNGKey(2), 2)
    av = jax.jit(audio.init)(r[0], jnp.zeros((1, W, 64)))
    pv = jax.jit(prior.init)(r[1], jnp.zeros((1, H, 2), jnp.int32), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, H, AUD)))
    params = {"prior": pv["params"], "audio": av["params"]}
    state = jsteps.PixelState(params, {"audio": av["batch_stats"]},
                              _adam(optax.clip_by_global_norm(t2.MAX_NORM)).init(params),
                              jnp.zeros((), jnp.int32))
    batches = []
    for i in range(3):
        b = t2._batch(10 + i)
        b["poses"] = _poses(20 + i, 330 if i != 1 else 258)
        batches.append(b)
    states, metrics, keeps = [jax.tree.map(np.asarray, state)], [], []
    for i, b in enumerate(batches):      # jitted: here its compile beats op by op
        key = jax.random.PRNGKey(100 + i)
        keeps.append(t2.jax_aud_keep(prior, state.params["prior"], key))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(states=states, metrics=metrics, batches=batches, keeps=keeps, jvars=jvars,
                sts=sts, prior=prior, audio=audio)


def _port_vqs(jvars, sts):
    tb, th = tv.VQVAE(78, 64, NH), tv.VQVAE(180, 64, NH)
    tb.load_state_dict(convert.convert_vqvae(jvars["body"]))
    th.load_state_dict(convert.convert_vqvae(jvars["hand"]))
    return tb, th, {k: _tstate(s) for k, s in sts.items()}


@pytest.mark.parametrize("n_steps", [1, 3])
def test_body_pixel_step_6d_matches_jax(pixel_run, n_steps):
    run = pixel_run
    tb, th, states = _port_vqs(run["jvars"], run["sts"])
    prior = tp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD)
    init, step = tsteps.make_body_pixel_step(prior, tv.AudioEncoder(num_hiddens=AUD), tb, th,
                                             states, LR, t2.MAX_NORM, rep6d=True)
    state = init(torch.Generator().manual_seed(0), "cpu")
    state.load_converted(convert.from_jax_pixel_state(run["states"][0]))
    counts.clear()
    for i in range(n_steps):
        before = {part: {k: p.detach().clone() for k, p in m.named_parameters()}
                  for part, m in state.models.items()}
        batch = {k: torch.tensor(v) for k, v in run["batches"][i].items()}
        state, m = step(state, dict(batch, aud_keep=torch.as_tensor(run["keeps"][i])))
        for k, v in run["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        t2._assert_update_close(state, before, run["states"][i], run["states"][i + 1],
                                f"step {i}")
    assert counts["nearest_code_plain"] == 2 * n_steps
    t2._assert_state_close(state, run["states"][n_steps], f"after {n_steps}")


def test_generate_conv_poses_6d_matches_jax(pixel_run):
    """JAX's 6-D BodyModels (the stage-2 state after 3 steps) and the port's
    on the same weights: under JAX's noise, equal tokens and (B, 4H, 258)
    conv poses within 1e-5."""
    run = pixel_run
    st = run["states"][3]
    prior_vars = {"params": st.params["prior"]}
    audio_vars = {"params": st.params["audio"], "batch_stats": st.batch_stats["audio"]}
    vb, vh = jv.VQVAE(in_dim=78, num_hiddens=NH), jv.VQVAE(in_dim=180, num_hiddens=NH)
    jmodels = jbody.BodyModels(vb, vh, run["jvars"]["body"], run["jvars"]["hand"],
                               run["sts"]["body"], run["sts"]["hand"], run["audio"],
                               audio_vars, run["prior"], prior_vars)
    S, T = 3, 24
    feat = np.random.default_rng(5).standard_normal((S, T, 64)).astype(np.float32)
    ids = np.asarray([0, 2, 3], np.int32)
    key = jax.random.PRNGKey(11)
    want, want_tok = jbody.generate_conv_poses(jmodels, jnp.asarray(feat), jnp.asarray(ids), key,
                                               use_fused=False)
    tb, th, states = _port_vqs(run["jvars"], run["sts"])
    prior = tp.GatedPixelCNN(input_dim=CODES, dim=DIM, n_layers=LAYERS, audio_channels=AUD)
    prior.load_state_dict(convert.convert_pixelcnn(prior_vars))
    audio = tv.AudioEncoder(num_hiddens=AUD)
    audio.load_state_dict(convert.convert_audio_encoder(jax.tree.map(np.asarray, audio_vars)))
    models = tbody.BodyModels(tb.eval(), th.eval(), states["body"], states["hand"],
                              audio.eval(), prior.eval())
    noise = torch.as_tensor(jax_noise_from_key(key, T // 4, S, CODES))
    got, tok = tbody.generate_conv_poses(models, torch.as_tensor(feat), torch.as_tensor(ids),
                                         noise=noise)
    assert got.shape == (S, T, 258)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_generate_chunks_at_the_kernels_largest_batch(monkeypatch):
    """generate_conv_poses decodes in chunks of `model_max_batch` (the
    largest batch one K1 launch takes at the prior's shape), each with its
    slice of the noise; here the limit is patched to 2, so 5 samples decode
    as 2 + 2 + 1 and give the tokens of one whole-batch decode."""
    gen = torch.Generator().manual_seed(3)
    models = tbody.create_body_models(gen, code_num=CODES, num_hiddens=NH, pixel_dim=DIM,
                                      pixel_layers=LAYERS, audio_channels=AUD, device="cpu",
                                      rep6d=True)
    feat = torch.randn((5, W, 64), generator=gen)
    ids = torch.tensor([0, 1, 2, 3, 0])
    noise = torch.randn((H, 2, 5, CODES), generator=gen)
    whole, tok_whole = tbody.generate_conv_poses(models, feat, ids, noise=noise)
    sizes = []
    real = tbody.sample_tokens_fused

    def spy(model, label, audio, **kw):
        sizes.append(audio.shape[0])
        return real(model, label, audio, **kw)

    monkeypatch.setattr(tbody, "model_max_batch", lambda prior, dtype: 2)
    monkeypatch.setattr(tbody, "sample_tokens_fused", spy)
    conv, tok = tbody.generate_conv_poses(models, feat, ids, noise=noise)
    assert sizes == [2, 2, 1] and conv.shape == (5, W, 258)
    assert torch.equal(tok, tok_whole) and torch.equal(conv, whole)


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
def test_k1_launch_plan_at_the_6d_prior(esize):
    """K1's host transcription of the chain's shared-memory carve: at dim
    512 x 10 layers a batch of 23 fits (a ring of >= 4 stages of 16 KB beside
    the gathered input's B (2d + 4) floats), 24 does not, and the decode's
    chunk is 23; at dim 256 x 15 every batch up to 32 fits, as before."""
    plan = ar_decode.launch_plan(23, 10, 512, 2048, 512, esize)
    assert plan is not None and plan["smem_bytes"] <= ar_decode.SMEM_CAP
    chunk = ar_decode.CHUNK_BYTES
    assert plan["ring_stages"] * chunk >= ar_decode.PART_BYTES + 2 * chunk
    assert ar_decode.launch_plan(24, 10, 512, 2048, 512, esize) is None
    assert ar_decode.max_batch(10, 512, 2048, 512, esize) == 23
    assert ar_decode.max_batch(15, 256, 2048, 512, esize) == ar_decode.MAX_BATCH == 32
    for B in (1, 2, 8, 32):
        assert ar_decode.launch_plan(B, 15, 256, 2048, 512, esize) is not None
    # the B = 1 carve keeps cls and column 1's v2h in shared memory, 12 stages
    assert ar_decode.launch_plan(1, 10, 512, 2048, 512, esize)["cls_smem"]


# ---------------------------------------------------------------------------
# the train CLI's 6-D stages
# ---------------------------------------------------------------------------

def test_cli_6d_stages(tmp_path, monkeypatch):
    """main() for s2g_body_vq and s2g_body_pixel with convert_to_6d: the
    VQ-VAEs built at 78 / 180 channels, the prior at the 6-D variant's dim
    512 x 10 layers (built narrow here), the synthetic windows 330 wide;
    finite logs; the pixel stage's frozen encode on the stage-1
    checkpoint's 6-D VQs."""
    built = []
    monkeypatch.setattr(cli, "VQVAE", lambda width, emb, nh: built.append(width) or
                        tv.VQVAE(width, emb, NH))
    monkeypatch.setattr(cli, "GatedPixelCNN", lambda **kw: built.append(
        (kw["dim"], kw["n_layers"])) or tp.GatedPixelCNN(
        input_dim=kw["input_dim"], dim=DIM, n_layers=LAYERS, n_classes=kw["n_classes"],
        audio_channels=AUD))
    monkeypatch.setattr(cli, "AudioEncoder", lambda num_hiddens: tv.AudioEncoder(
        num_hiddens=AUD))
    cfgs = {}
    for name in ("s2g_body_vq", "s2g_body_pixel"):
        cfg = {"Data": {"pose": {"generate_length": W, "convert_to_6d": True}},
               "Model": {"model_name": name, "code_num": CODES},
               "DataLoader": {"batch_size": B},
               "Train": {"epochs": 1, "learning_rate": {"generator_learning_rate": 1e-3}},
               "Log": {"save_every": 1, "print_every": 3, "name": "t"}}
        cfgs[name] = str(tmp_path / f"{name}.json")
        with open(cfgs[name], "w") as f:
            json.dump(cfg, f)
    base = ["--synthetic", "--epochs", "1", "--device", "cpu"]
    vq = cli.main(["--config_file", cfgs["s2g_body_vq"], "--run_dir", str(tmp_path / "vq")]
                  + base)
    assert built == [78, 180] and vq.dataset.clips[0].poses.shape[-1] == 330
    counts.clear()
    px = cli.main(["--config_file", cfgs["s2g_body_pixel"], "--run_dir", str(tmp_path / "px"),
                   "--vq_ckpt", str(tmp_path / "vq" / "ckpt-0.pt")] + base)
    assert built[2:] == [78, 180, (512, 10)] and px.global_step >= cli.SYNTHETIC_STEPS
    assert counts["nearest_code_plain"] > 0
    for run in ("vq", "px"):
        hist = json.load(open(tmp_path / run / "history.json"))
        assert all(np.isfinite(v) for h in hist for v in h.values())
    keys = sorted(px._token_cache)          # every window, cached after epoch 1
    assert set(keys) == set(px.dataset.window_keys())
    poses = torch.as_tensor(np.stack([px.dataset.window_poses(k) for k in keys]))
    want = tsteps.make_token_encoder(vq.state.models["body"], vq.state.models["hand"],
                                     vq.state.vq, rep6d=True)(poses)
    assert torch.equal(px.token_encoder(poses), want)
    assert np.array_equal(np.stack([px._token_cache[k] for k in keys]), want.numpy())

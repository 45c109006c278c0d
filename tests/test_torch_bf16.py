"""Mixed-precision (`--bf16`) training of the port against the JAX
package's bf16 programs on the CPU, at the toy widths of
tests/test_torch_train_pixel.py and tests/test_torch_train_face.py.

Both sides compute in bf16 at flax's `dtype` sites with f32 parameters,
but they round in different places: XLA on the CPU may keep a fused
elementwise chain in f32 where PyTorch rounds each op, and the port's
frozen extractor is K3's arithmetic on bf16 tables (one rounding a layer)
where flax rounds each conv and each gelu.  So the bounds come from bf16's precision (8 significant bits: an
operand rounds by up to 2^-9 of itself, an output by a few such steps after
12 layers), set at about twice the largest difference seen, here against
JAX at toy width [in brackets] or in chip_smoke.py phase 30, where the same
bounds hold one step at full width on the card against the CPU {in braces,
NVIDIA H100 80GB HBM3, 700 W}:
  - teacher-forced logits: within 0.05 of JAX's f32 logits (JAX's own
    bound, tests/test_train_steps.py:176) [0.0409] and 0.0625 of JAX's bf16
    logits [0.03125, one bf16 ulp at |logit| in [4, 8)];
  - the body-pixel step from one state: ce within 1e-3 relative [2.9e-5]
    {6.5e-5}, the gradients' global norm 1.5e-2 [6.2e-3] {1.3e-4}; Adam's
    first moment (0.1 x the clipped gradient) within 0.1 of its model's
    largest [4.7e-2] {5.3e-2}; f32 masters after the step within 2 lr
    [2 lr] {2 lr}: Adam's first step moves each by about lr sign(g), and a
    gradient that is rounding noise may take either sign; float32 on both
    sides;
  - the face step (stochastic, JAX's own masks) from one state: the losses
    within 1e-2 relative [2.9e-4] {3.5e-3}, the gradient norm 1e-2
    [1.8e-3] {5.1e-3}; the SGD momentum (the clipped gradient) within 0.1 of
    its largest [2.0e-2] {5.3e-2}; f32 masters within 0.1 lr x that largest
    of JAX's [2.0e-2] {5.3e-2}.
The f32 programs stay held at 1e-5 by the other test files."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models import face as jface
from talkshow_tpu.models import pixelcnn as jp
from talkshow_tpu.models import wav2vec as jw2v
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert
from talkshow_torch.kernels import counts
from talkshow_torch.models import face as tface
from talkshow_torch.models import pixelcnn as tp
from talkshow_torch.models import vqvae as tv
from talkshow_torch.models import wav2vec as tw2v
from talkshow_torch.train import __main__ as cli
from talkshow_torch.train import steps as tsteps
import test_torch_train_face as tf
import test_torch_train_pixel as tpx

torch.set_num_threads(2)
BF16 = torch.bfloat16


def _f32_leaves(tree):
    """Every float leaf of a JAX state is float32."""
    dts = [np.asarray(a).dtype for a in jax.tree_util.tree_leaves(tree)]
    return all(d == np.float32 for d in dts if np.issubdtype(d, np.floating))


def test_bf16_teacher_forced_logits():
    kw = dict(input_dim=tpx.CODES, dim=tpx.DIM, n_layers=tpx.LAYERS, audio_channels=tpx.AUD)
    prior32, prior16 = jp.GatedPixelCNN(**kw), jp.GatedPixelCNN(dtype=jnp.bfloat16, **kw)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, tpx.CODES, (4, 6, 2)).astype(np.int32)
    label = np.arange(4, dtype=np.int32)
    audio = rng.standard_normal((4, 6, tpx.AUD)).astype(np.float32)
    args = (jnp.asarray(tokens), jnp.asarray(label), jnp.asarray(audio))
    variables = tpx._randomize(jax.jit(prior32.init)(jax.random.PRNGKey(8), *args), 3)
    lg32 = np.asarray(jax.jit(prior32.apply)(variables, *args))
    lg16 = jax.jit(prior16.apply)(variables, *args)
    assert lg16.dtype == jnp.bfloat16
    port = tp.GatedPixelCNN(dtype=BF16, **kw)
    port.load_state_dict(convert.convert_pixelcnn(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        got = port(*(torch.as_tensor(a).long() if a.dtype == np.int32 else torch.as_tensor(a)
                     for a in (tokens, label, audio)))
    assert got.dtype == BF16 and all(p.dtype == torch.float32 for p in port.parameters())
    got = got.float().numpy()
    assert np.abs(got - lg32).max() <= 0.05
    assert np.abs(got - np.asarray(lg16, np.float32)).max() <= 0.0625
    assert np.abs(got - lg32).max() > 0       # bf16 engaged


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_bf16_pixel_step_matches_jax():
    vb, vh, jvars, sts, _, audio = tpx._jax_models()
    prior16 = jp.GatedPixelCNN(input_dim=tpx.CODES, dim=tpx.DIM, n_layers=tpx.LAYERS,
                               audio_channels=tpx.AUD, dtype=jnp.bfloat16)
    init, step = jsteps.make_body_pixel_step(prior16, audio, vb, vh, jvars, sts,
                                             learning_rate=tpx.LR, max_grad_norm=tpx.MAX_NORM)
    s0 = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(2), window=tpx.W)
    batch = tpx._batch(10)
    key = jax.random.PRNGKey(100)
    keep = tpx.jax_aud_keep(prior16, s0.params["prior"], key)
    s1, m = step(s0, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    s0, s1 = jax.tree.map(np.asarray, s0), jax.tree.map(np.asarray, s1)
    assert _f32_leaves(s1.params) and _f32_leaves(s1.opt_state)

    tb, th = tv.VQVAE(39, 64, tpx.NH), tv.VQVAE(90, 64, tpx.NH)
    tb.load_state_dict(convert.convert_vqvae(jvars["body"]))
    th.load_state_dict(convert.convert_vqvae(jvars["hand"]))
    prior = tp.GatedPixelCNN(input_dim=tpx.CODES, dim=tpx.DIM, n_layers=tpx.LAYERS,
                             audio_channels=tpx.AUD, dtype=BF16)
    pinit, pstep = tsteps.make_body_pixel_step(
        prior, tv.AudioEncoder(num_hiddens=tpx.AUD), tb, th,
        {k: tpx._tstate(s) for k, s in sts.items()}, tpx.LR, tpx.MAX_NORM)
    state = pinit(torch.Generator().manual_seed(0), "cpu")
    w0 = convert.from_jax_pixel_state(s0)
    assert all(v.dtype == torch.float32 for part in ("prior", "audio") for v in w0[part].values())
    state.load_converted(w0)
    state, mt = pstep(state, dict(tpx._torch_batch(batch), aud_keep=torch.as_tensor(keep)))
    assert _rel(mt["ce_loss"], m["ce_loss"]) <= 1e-3
    assert _rel(mt["grad"], m["grad"]) <= 1.5e-2
    w1 = convert.from_jax_pixel_state(s1)
    for part, model in state.models.items():
        top = max(v.abs().max().item() for v in w1["exp_avg"][part].values())
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32
            mom = state.optimizer.adam.state[p]["exp_avg"]
            assert (mom - w1["exp_avg"][part][name]).abs().max().item() <= 0.1 * top, name
            assert (p.detach() - w1[part][name]).abs().max().item() <= 2 * tpx.LR * 1.0001, name


def test_bf16_face_step_matches_jax():
    cfg = dict(tf.TINY, dtype=jnp.bfloat16)
    face16 = jface.FaceGenerator(wav2vec_cfg=jw2v.Wav2Vec2Config(**cfg))
    init, step = jsteps.make_face_step(face16, learning_rate=tf.LR, momentum=0.9,
                                       max_grad_norm=tf.MAX_NORM, window=tf.T)
    s0 = jax.jit(init, static_argnames=("samples_per_window", "window"))(
        jax.random.PRNGKey(0), samples_per_window=tf.N, window=tf.T)
    batch = tf._batch(20)
    key = jax.random.PRNGKey(200)
    starts, keep = tf.jax_face_masks(face16, s0.params, batch, key)
    s1, m = step(s0, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    s0, s1 = jax.tree.map(np.asarray, s0), jax.tree.map(np.asarray, s1)
    assert _f32_leaves(s1.params)

    face = tface.FaceGenerator(tw2v.Wav2Vec2Config(**dict(tf.TINY, dtype=BF16)))
    pinit, pstep = tsteps.make_face_step(face, tf.LR, 0.9, tf.MAX_NORM)
    state = pinit(torch.Generator().manual_seed(0), "cpu")
    w0 = convert.from_jax_face_state(s0)
    assert all(v.dtype == torch.float32 for v in w0["face"].values())
    state.load_converted(w0)
    assert state.tables["w0"].dtype == BF16       # the frozen extractor on bf16 tables
    counts.clear()
    state, mt = pstep(state, dict(tf._torch(batch), spec_starts=torch.tensor(starts),
                                  drop_keep=torch.tensor(keep)))
    assert counts["extractor_plain"] == 1
    for k in ("loss", "MSELoss", "exp_loss"):
        assert _rel(mt[k], m[k]) <= 1e-2, k
    assert _rel(mt["grad"], m["grad"]) <= 1e-2
    w1 = convert.from_jax_face_state(s1)
    sgd = state.optimizer.inner
    ttop = max(v.abs().max().item() for v in w1["trace"].values())
    sd = state.face.state_dict()
    for name, p in state.face.named_parameters():
        assert p.dtype == torch.float32
        if p.requires_grad:
            err = (sgd.state[p]["momentum_buffer"] - w1["trace"][name]).abs().max().item()
            assert err <= 0.1 * ttop, name
    for k, w in w1["face"].items():
        assert (sd[k] - w).abs().max().item() <= 0.1 * tf.LR * ttop, k


@pytest.mark.parametrize("stage", ["s2g_body_pixel", "s2g_face"])
def test_train_cli_bf16(tmp_path, monkeypatch, stage):
    """main(--bf16) for the two stages that honour it (narrow models): the
    model computes in bf16, the checkpoint holds f32 tensors only, logs are
    finite; the face step's frozen extractor takes bf16 tables."""
    tpx._narrow(monkeypatch)
    monkeypatch.setattr(cli, "GatedPixelCNN", lambda **kw: tp.GatedPixelCNN(
        input_dim=kw["input_dim"], dim=tpx.DIM, n_layers=tpx.LAYERS, n_classes=kw["n_classes"],
        audio_channels=tpx.AUD, bh_model=kw["bh_model"], dtype=kw["dtype"]))
    monkeypatch.setattr(cli, "FaceGenerator", lambda cfg=None: tface.FaceGenerator(
        tw2v.Wav2Vec2Config(**dict(tf.TINY, dtype=cfg.dtype if cfg else None))))
    base = ["--synthetic", "--epochs", "1", "--device", "cpu", "--bf16"]
    run = tmp_path / "run"
    if stage == "s2g_body_pixel":
        vq_cfg = tpx._write_config(tmp_path / "vq.json", "s2g_body_vq")
        cli.main(["--config_file", vq_cfg, "--run_dir", str(tmp_path / "vq")] + base)
        px_cfg = tpx._write_config(tmp_path / "px.json", "s2g_body_pixel")
        tr = cli.main(["--config_file", px_cfg, "--run_dir", str(run), "--vq_ckpt",
                       str(tmp_path / "vq" / "ckpt-0.pt")] + base)
        assert tr.state.models["prior"].dtype == BF16
        # the --bf16 checkpoint loads into a Pipeline unchanged, whose decode
        # reads f32 parameters
        from talkshow_torch.eval.__main__ import pixel_weights, vq_weights
        from talkshow_torch.pipeline import Pipeline
        pipe = Pipeline.create(0, "cpu", wav2vec_cfg=tw2v.Wav2Vec2Config(**tf.TINY),
                               num_hiddens=tpx.NH, pixel_dim=tpx.DIM, pixel_layers=tpx.LAYERS,
                               code_num=tpx.CODES, audio_channels=tpx.AUD)
        load = lambda p: torch.load(p, map_location="cpu", weights_only=True)  # noqa: E731
        pipe.load_converted({**pixel_weights(load(run / "ckpt-0.pt")),
                             **vq_weights(load(tmp_path / "vq" / "ckpt-0.pt"))})
        feat = np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32)
        motion = pipe.generate_body(feat, 0, seed=0)
        assert motion.shape == (1, 32, 129) and np.isfinite(motion).all()
        assert pipe.body.prior.dtype is None
    else:
        tr = cli.main(["--config_file", tf._write_face_config(tmp_path / "face.json"),
                       "--run_dir", str(run)] + base)
        assert tr.state.face.audio_encoder.cfg.dtype == BF16
        assert tr.state.tables["w0"].dtype == BF16
    hist = json.load(open(run / "history.json"))
    assert tr.global_step > 0 and all(np.isfinite(v) for h in hist for v in h.values())
    sd = torch.load(run / "ckpt-0.pt", map_location="cpu", weights_only=True)["state"]

    def floats(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in floats(v)]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in floats(v)]
        return [x] if torch.is_tensor(x) and x.is_floating_point() else []

    assert floats(sd) and all(t.dtype == torch.float32 for t in floats(sd))

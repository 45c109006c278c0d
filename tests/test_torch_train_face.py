"""Training stage 3 of the port (the face step with its frozen extractor,
SpecAugment and dropout, the whole-clip and bucketed face batches, the
CLI stage) and the `masked_spec_embed` repair, against the JAX package on
the CPU at toy widths: wav2vec of 2 layers, 32 wide, a 2-conv 16-channel
extractor; 1 s clips (30 frames) at batch 2.

Tolerances: losses and the gradient norm within 1e-5 relative; parameters
and the SGD momentum within 1e-5 of their largest (the same f32 math
summed in another order; SGD moves each parameter by lr times its
momentum, so a gradient's rounding stays at its own scale).  JAX's masks
are recovered for the same keys and shown to reproduce JAX's own train
forward bit for bit before the port is held to them.  Batches, masks and
the frozen extractor are equal exactly."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from talkshow_tpu.data import dataset as jdata
from talkshow_tpu.models import face as jface
from talkshow_tpu.models import wav2vec as jw2v
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert
from talkshow_torch.data import dataset as tdata
from talkshow_torch.kernels import counts
from talkshow_torch.models import face as tface
from talkshow_torch.models import wav2vec as tw2v
from talkshow_torch.pipeline import Pipeline, load_pipeline, save_pipeline
from talkshow_torch.train import __main__ as cli
from talkshow_torch.train import steps as tsteps
from test_torch_reference_ckpt import _load, _t, golden  # noqa: F401 (a fixture)

torch.set_num_threads(2)
TOL = 1e-5
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
B, N, T = 2, 16000, 30
LR = 1e-3
#: below the first step's gradient norm, so that step takes the clip branch
MAX_NORM = 1.0


def _batch(seed, batch=B):
    rng = np.random.default_rng(seed)
    ids = np.zeros((batch, 4), np.float32)
    ids[np.arange(batch), np.arange(batch) % 4] = 1.0
    return {"waveform": rng.standard_normal((batch, N)).astype(np.float32),
            "id_onehot": ids,
            "gt": (0.3 * rng.standard_normal((batch, T, 265))).astype(np.float32)}


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def jax_face_masks(face, params, batch, rng, frames=T):
    """JAX's own SpecAugment starts (B, num_masks) and middle-dropout keep
    mask (B, T, 256) for the face step's key `rng` (split into its dropout
    and spec_augment keys as steps.py:283 splits it), and the proof: JAX's
    train forward with these masks put in by interceptors equals its train
    forward with the keys, bit for bit."""
    r_drop, r_mask = jax.random.split(rng)
    key = face.apply({"params": params}, rngs={"spec_augment": r_mask},
                     method=lambda m: m.audio_encoder.make_rng("spec_augment"))
    nb = batch["waveform"].shape[0]
    starts = np.asarray(jax.random.randint(key, (nb, tw2v.spec_mask_count(frames)), 0,
                                           max(frames - tw2v.MASK_TIME_LENGTH, 1)))
    kw = {k: jnp.asarray(batch[k]) for k in ("valid_samples", "valid_frames") if k in batch}
    args = (jnp.asarray(batch["waveform"]), jnp.asarray(batch["id_onehot"]), frames, True)
    want = face.apply({"params": params}, *args, rngs={"dropout": r_drop, "spec_augment": r_mask},
                      freeze_extractor=True, **kw)
    kept = {}

    def record(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, nn.Dropout) and ctx.method_name == "__call__":
            # flax's own Dropout on ones under the step's key: its mask
            kept["mask"] = np.asarray(next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)) != 0
        return next_fun(*args, **kwargs)

    def inject(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, nn.Dropout) and ctx.method_name == "__call__":
            return jnp.where(kept["mask"], args[0] / 0.9, 0.0)
        if isinstance(ctx.module, jw2v.Wav2Vec2Encoder) and ctx.method_name == "_spec_augment":
            x = args[0]
            pos = jnp.arange(x.shape[1])[None, None]
            span = ((pos >= starts[..., None]) & (pos < starts[..., None] + 10)).any(1)
            return jnp.where(span[..., None], ctx.module.masked_spec_embed, x)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        face.apply({"params": params}, *args, rngs={"dropout": r_drop}, freeze_extractor=True,
                   **kw)
    # other keys: only the recovered masks can reproduce the step's forward
    with nn.intercept_methods(inject):
        got = face.apply({"params": params}, *args,
                         rngs={"dropout": jax.random.PRNGKey(1), "spec_augment": r_drop},
                         freeze_extractor=True, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    return starts, kept["mask"]


def _jax_face():
    return jface.FaceGenerator(wav2vec_cfg=jw2v.Wav2Vec2Config(**TINY))


@pytest.fixture(scope="module")
def jax_runs():
    """Three JAX face steps, deterministic and stochastic, from one state;
    the states (numpy) before and after each, metrics, batches and the
    stochastic steps' masks."""
    face = _jax_face()
    out = {}
    for stochastic in (False, True):
        init, step = jsteps.make_face_step(face, learning_rate=LR, momentum=0.9,
                                           max_grad_norm=MAX_NORM, window=T,
                                           stochastic=stochastic)
        state = jax.jit(init, static_argnames=("samples_per_window", "window"))(
            jax.random.PRNGKey(0), samples_per_window=N, window=T)
        batches = [_batch(20 + i) for i in range(3)]
        states, metrics, masks = [jax.tree.map(np.asarray, state)], [], []
        for i, b in enumerate(batches):
            key = jax.random.PRNGKey(200 + i)
            if stochastic:
                masks.append(jax_face_masks(face, state.params, b, key))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
            states.append(jax.tree.map(np.asarray, state))
            metrics.append({k: float(v) for k, v in m.items()})
        out[stochastic] = dict(states=states, metrics=metrics, batches=batches, masks=masks)
    return out


def _port(jax_state=None, stochastic=True):
    face = tface.FaceGenerator(tw2v.Wav2Vec2Config(**TINY))
    init, step = tsteps.make_face_step(face, LR, 0.9, MAX_NORM, stochastic)
    state = init(torch.Generator().manual_seed(0), "cpu")
    if jax_state is not None:
        state.load_converted(convert.from_jax_face_state(jax_state))
    return state, step


def _assert_state_close(state, jax_state, tag):
    want = convert.from_jax_face_state(jax_state)
    assert state.step == want["step"]
    assert state.optimizer.nonfinite_count == want["nonfinite_count"]
    sd = state.face.state_dict()
    assert sd.keys() == want["face"].keys()
    top = max(v.abs().max().item() for v in want["face"].values())
    for k, w in want["face"].items():
        err = (sd[k] - w).abs().max().item()
        assert err <= TOL * top, (tag, k, err)
    sgd = state.optimizer.inner
    ttop = max(v.abs().max().item() for v in want["trace"].values())
    for name, p in state.face.named_parameters():
        if not p.requires_grad:
            assert name.startswith("audio_encoder.feature_extractor.") and p not in sgd.state
            continue
        err = (sgd.state[p]["momentum_buffer"] - want["trace"][name]).abs().max().item()
        assert err <= TOL * max(ttop, 1e-12), (tag, "trace", name, err)


# ---------------------------------------------------------------------------
# (a) the masks
# ---------------------------------------------------------------------------

def test_spec_augment_and_dropout_masks(jax_runs):
    """Shapes, span counts and rates of both sides' masks; JAX's recovered
    masks reproduce its train forward (inside jax_face_masks); the port's
    SpecAugment of the same starts equals JAX's span mask."""
    starts, keep = jax_runs[True]["masks"][0]
    assert starts.shape == (B, 2) and keep.shape == (B, T, 256) and keep.dtype == bool
    assert tw2v.spec_mask_count(T) == 2 and tw2v.spec_mask_count(300) == 2
    assert tw2v.spec_mask_count(400) == 2 and tw2v.spec_mask_count(500) == 2
    assert tw2v.spec_mask_count(600) == 3 and tw2v.spec_mask_count(2400) == 12
    assert (starts >= 0).all() and (starts < T - 10).all()
    gen = torch.Generator().manual_seed(3)
    s = tw2v.draw_spec_starts(64, 600, gen, "cpu")
    assert s.shape == (64, 3) and int(s.min()) >= 0 and int(s.max()) < 590
    k = tface.draw_drop_keep((8, 300, 256), gen, "cpu")
    assert k.shape == (8, 300, 256) and abs(1 - k.float().mean().item() - 0.1) < 0.005
    assert abs(1 - keep.mean() - 0.1) < 0.03
    x = torch.randn(B, T, 32)
    embed = torch.full((32,), 7.0)
    got = tw2v.spec_augment(x, torch.tensor(starts), embed)
    pos = np.arange(T)[None, None]
    span = ((pos >= starts[..., None]) & (pos < starts[..., None] + 10)).any(1)
    np.testing.assert_array_equal((got == 7.0).all(-1).numpy(), span)
    np.testing.assert_array_equal(got[~torch.as_tensor(span)].numpy(),
                                  x[~torch.as_tensor(span)].numpy())


# ---------------------------------------------------------------------------
# (b) the step from one converted state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_face_step_matches_jax(jax_runs, stochastic, n_steps):
    run = jax_runs[stochastic]
    state, step = _port(run["states"][0], stochastic)
    _assert_state_close(state, run["states"][0], "start")
    extractor = {k: v.clone() for k, v in
                 state.face.audio_encoder.feature_extractor.state_dict().items()}
    counts.clear()
    for i in range(n_steps):
        batch = _torch(run["batches"][i])
        if stochastic:
            starts, keep = run["masks"][i]
            batch.update(spec_starts=torch.tensor(starts), drop_keep=torch.tensor(keep))
        state, m = step(state, batch)
        for k, v in run["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        _assert_state_close(state, run["states"][i + 1], f"step {i}")
    assert run["metrics"][0]["grad"] > MAX_NORM       # the first step took the clip branch
    # the frozen extractor: its plain route on the CPU once a step, no
    # gradient, parameters bit-equal
    assert counts["extractor_plain"] == n_steps and counts["face_plain"] == 0
    for k, v in state.face.audio_encoder.feature_extractor.state_dict().items():
        assert torch.equal(v, extractor[k]), k
    assert all(p.grad is None and not p.requires_grad
               for p in state.face.audio_encoder.feature_extractor.parameters())


def test_frozen_features_carry_no_graph():
    state, _ = _port()
    wav = torch.randn(1, N)
    from talkshow_torch.models.wav2vec_fused import frozen_features
    enc = state.face.audio_encoder
    feats = frozen_features(enc, wav, tables=state.tables)
    assert not feats.requires_grad and feats.grad_fn is None
    with torch.no_grad():
        want = enc.feature_extractor(wav)
    # the plain K3 version against the module: the same convolutions, the
    # later layers' weights taken from K3's tap-major table
    np.testing.assert_allclose(feats.numpy(), want.numpy(), rtol=0,
                               atol=TOL * want.abs().max().item())
    masked = frozen_features(enc, wav, torch.tensor([N - 3000]), tables=state.tables)
    assert not masked.requires_grad and masked.shape == want.shape


def test_nonfinite_face_step_is_skipped(jax_runs):
    run = jax_runs[False]
    state, step = _port(run["states"][1], stochastic=False)
    before = {k: v.clone() for k, v in state.face.state_dict().items()}
    bufs = {id(p): s["momentum_buffer"].clone() for p, s in state.optimizer.inner.state.items()}
    bad = _torch(run["batches"][0])
    bad["gt"][0, 0, 200] = float("nan")
    state, m = step(state, bad)
    assert m["nonfinite_skips"] == 1 and state.step == 2
    assert all(torch.equal(v, before[k]) for k, v in state.face.state_dict().items())
    assert all(torch.equal(s["momentum_buffer"], bufs[id(p)])
               for p, s in state.optimizer.inner.state.items())
    state, m = step(state, _torch(run["batches"][0]))
    assert m["nonfinite_skips"] == 1 and np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# (c) bucketed batches
# ---------------------------------------------------------------------------

def _bucketed(batch, bucket=32):
    """The batch padded to `bucket` frames, as face_batches pads it."""
    spf = -(-16000 // 30)
    nb = bucket * spf
    wav = np.zeros((batch["waveform"].shape[0], nb), np.float32)
    wav[:, :N] = batch["waveform"]
    gt = np.zeros((batch["gt"].shape[0], bucket, 265), np.float32)
    gt[:, :T] = batch["gt"]
    nbat = wav.shape[0]
    return dict(batch, waveform=wav, gt=gt, valid_samples=np.full(nbat, N, np.int32),
                valid_frames=np.full(nbat, T, np.int32))


def test_bucketed_face_step_matches_jax(jax_runs):
    """A padded batch with SpecAugment and dropout, from one state: JAX's
    and the port's step agree as on whole clips."""
    run = jax_runs[True]
    face = _jax_face()
    init, step = jsteps.make_face_step(face, learning_rate=LR, momentum=0.9,
                                       max_grad_norm=MAX_NORM, window=T)
    jstate = jax.tree.map(jnp.asarray, run["states"][1])
    batch = _bucketed(run["batches"][1])
    key = jax.random.PRNGKey(31)
    starts, keep = jax_face_masks(face, jstate.params, batch, key, frames=32)
    jnext, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    state, pstep = _port(run["states"][1])
    counts.clear()
    state, m = pstep(state, dict(_torch(batch), spec_starts=torch.tensor(starts),
                                 drop_keep=torch.tensor(keep)))
    assert counts["extractor_plain"] == 1       # the plain masked extractor
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=TOL, atol=1e-7, err_msg=k)
    _assert_state_close(state, jax.tree.map(np.asarray, jnext), "bucketed")


def test_bucketed_face_batch_equals_unbucketed_on_real_frames(jax_runs):
    """Deterministic steps from one state: a clip padded to a 32-frame
    bucket against the clip alone (loss, gradient norm and the updated
    parameters within 1e-5), and both clips of a padded batch of 2 against
    each alone on their real frames."""
    run = jax_runs[False]
    one = {k: v[:1] for k, v in run["batches"][0].items()}
    (a, step), (b, _) = _port(run["states"][0], False), _port(run["states"][0], False)
    _, ma = step(a, _torch(one))
    _, mb = step(b, _torch(_bucketed(one)))
    for k in ("loss", "MSELoss", "exp_loss", "grad"):
        np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=TOL, err_msg=k)
    sa = a.face.state_dict()
    assert all((v - sa[k]).abs().max().item() <= TOL for k, v in b.face.state_dict().items())
    face = a.face
    pad = _torch(_bucketed(run["batches"][0]))
    with torch.no_grad():
        feats = face.audio_encoder.feature_extractor(pad["waveform"], pad["valid_samples"])
        both = face.train_forward(feats, pad["id_onehot"], 32, pad["valid_samples"],
                                  pad["valid_frames"])
        for j in range(B):
            wav = torch.as_tensor(run["batches"][0]["waveform"][j:j + 1])
            alone = face.train_forward(face.audio_encoder.feature_extractor(wav),
                                       pad["id_onehot"][j:j + 1], T)
            np.testing.assert_allclose(both[j, :T].numpy(), alone[0].numpy(), rtol=TOL,
                                       atol=TOL)


# ---------------------------------------------------------------------------
# (d) face batches and synthetic clips against JAX's
# ---------------------------------------------------------------------------

def _jax_face_dataset(bucketed):
    """scripts/train.py:76-99's synthetic raw-waveform clips, on JAX's dataset."""
    ds = jdata.synthetic_dataset(num_clips=4, frames=240)
    rng0 = np.random.default_rng(0)
    tmin = min(c.poses.shape[0] for c in ds.clips)
    for i, c in enumerate(ds.clips):
        t = c.poses.shape[0] - 7 * i if bucketed else tmin
        c.poses, c.expression = c.poses[:t], c.expression[:t]
        c.aud_feat = rng0.standard_normal((t * 16000 // 30, 1)).astype(np.float32)
    return ds


@pytest.mark.parametrize("bucket,batch", [(0, 1), (32, 2), (64, 3)])
def test_face_batches_match_jax(bucket, batch):
    t = tdata.synthetic_face_dataset(4, 240, bucketed=bool(bucket))
    j = _jax_face_dataset(bool(bucket))
    for a, b in zip(t.clips, j.clips):
        for f in ("poses", "expression", "aud_feat"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    tb = list(t.face_batches(bucket_frames=bucket, batch_size=batch))
    jb = list(j.face_batches(bucket_frames=bucket, batch_size=batch))
    assert len(tb) == len(jb) >= 2
    for x, y in zip(tb, jb):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    lengths = {c.poses.shape[0] for c in t.clips}
    assert len(lengths) == (4 if bucket else 1)
    with pytest.raises(ValueError, match="raw"):
        next(tdata.synthetic_dataset(1, 40).face_batches())


# ---------------------------------------------------------------------------
# (e) the masked_spec_embed repair
# ---------------------------------------------------------------------------

def test_masked_spec_embed_carried_from_jax_and_reference(golden):  # noqa: F811
    """The vector crosses from a JAX face tree and from the reference .pth
    (the file's own values); a reference file without it gets zeros, as the
    JAX converter gives one; the face stage's output on the golden file is
    unchanged (expected.npz, 5e-4 as the JAX test)."""
    face = _jax_face()
    variables = jax.jit(face.init, static_argnums=3)(jax.random.PRNGKey(4), jnp.zeros((1, N)),
                                                     jnp.zeros((1, 4)), T)
    sd = convert.convert_face(jax.tree.map(np.asarray, variables))
    want = np.asarray(variables["params"]["audio_encoder"]["masked_spec_embed"])
    np.testing.assert_array_equal(sd[convert.MASKED_SPEC_EMBED].numpy(), want)
    tface.FaceGenerator(tw2v.Wav2Vec2Config(**TINY)).load_state_dict(sd)    # strict

    meta, exp = golden
    ckpt = _load("face.pth")
    ref = convert.reference_face(ckpt)
    raw = ckpt["generator"]["generator"]["audio_encoder.masked_spec_embed"]
    assert torch.equal(ref[convert.MASKED_SPEC_EMBED], raw.float())
    model = tface.FaceGenerator(convert.config_from_hf(meta["hf_wav2vec"]))
    model.load_state_dict(ref)
    with torch.no_grad():
        out = model.eval()(_t(exp["face_wav"])[None], torch.zeros((1, 4)),
                           exp["face_out"].shape[1])
    np.testing.assert_allclose(out.numpy(), exp["face_out"], atol=5e-4)
    inner = dict(ckpt["generator"]["generator"])
    del inner["audio_encoder.masked_spec_embed"]
    old = convert.reference_face(inner)
    assert not old[convert.MASKED_SPEC_EMBED].any()
    assert old[convert.MASKED_SPEC_EMBED].shape == raw.shape


def test_weights_file_without_masked_spec_embed_still_loads(tmp_path):
    """A `save_pipeline` file written before the face stage carried the
    vector loads through load_pipeline (the vector set to zeros) and gives
    the same face output; Pipeline.create's seeded weights do not move."""
    cfg = tw2v.Wav2Vec2Config(**TINY)
    body = dict(num_hiddens=16, pixel_dim=16, pixel_layers=2, code_num=64)
    pipe = Pipeline.create(3, "cpu", wav2vec_cfg=cfg, **body)
    again = Pipeline.create(3, "cpu", wav2vec_cfg=cfg, **body)
    assert all(torch.equal(v, again.face_model.state_dict()[k])
               for k, v in pipe.face_model.state_dict().items())
    path = str(tmp_path / "old.pt")
    save_pipeline(pipe, path)
    weights = torch.load(path, weights_only=True)
    del weights["face"][convert.MASKED_SPEC_EMBED]
    torch.save(weights, path)
    loaded = load_pipeline(path, template=Pipeline.create(9, "cpu", wav2vec_cfg=cfg, **body))
    assert not loaded.face_model.audio_encoder.masked_spec_embed.any()
    wav = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    np.testing.assert_array_equal(loaded.generate_face(wav), pipe.generate_face(wav))


# ---------------------------------------------------------------------------
# (f) the CLI stage
# ---------------------------------------------------------------------------

def _write_face_config(path):
    with open(path, "w") as f:
        json.dump({"Model": {"model_name": "s2g_face", "encoder_choice": "faceformer"},
                   "Train": {"epochs": 1},
                   "Log": {"save_every": 1, "print_every": 2, "name": "face"}}, f)
    return str(path)


@pytest.mark.parametrize("bucket", [0, 32], ids=["whole_clips", "face_bucket"])
def test_face_cli(tmp_path, monkeypatch, bucket):
    """main() for s2g_face (toy wav2vec): whole clips at batch 1 through the
    extractor's unmasked route, or --face_bucket 32 --face_batch_size 2
    through the masked one; finite logs; the extractor unchanged."""
    monkeypatch.setattr(cli, "FaceGenerator",
                        lambda cfg=None: tface.FaceGenerator(tw2v.Wav2Vec2Config(**TINY)))
    cfg = _write_face_config(tmp_path / "face.json")
    argv = ["--config_file", cfg, "--synthetic", "--device", "cpu", "--run_dir",
            str(tmp_path / "run")]
    if bucket:
        argv += ["--face_bucket", str(bucket), "--face_batch_size", "2"]
    counts.clear()
    tr = cli.main(argv)
    shapes = [b["gt"].shape[:2] for b in tr.batch_iter(0)]
    assert tr.global_step == len(shapes)
    if bucket:
        assert len(shapes) < 4 and all(t % 32 == 0 for _, t in shapes)
    else:
        assert len(shapes) == 4 and len(set(shapes)) == 1 and shapes[0][0] == 1
    assert counts["extractor_plain"] == tr.global_step and counts["face_plain"] == 0
    hist = json.load(open(tmp_path / "run" / "history.json"))
    assert all(np.isfinite(v) for h in hist for v in h.values())
    assert "exp_loss=" in open(tmp_path / "run" / "train.log").read()
    assert all(not p.requires_grad for p in tr.state.face.audio_encoder.feature_extractor.parameters())

"""The port's face step (stage 3) on a dp x tp mesh in one 4-process gloo
group on the CPU (tests/torch_dist_check.py's face cases,
OMP_NUM_THREADS=1, joined with its own 90 s timeout), against the
one-process step on the global batch and against JAX's one-device step.

Toy widths chosen so that tp splits what JAX shards: wav2vec of 2 layers,
512 hidden, 8 heads, FFN 1024, an extractor of conv_dim (512, 64) (its
first conv passes `param_spec`, so the rule that leaves frozen weights
whole is exercised), a positional conv of 16 taps in 16 groups; 1 s clips
(T = 30).  The state is JAX's `make_face_step` init through
`convert.from_jax_face_state`.

- (dp 4, tp 1): a bucketed global batch of 4 clips (30, 27, 24, 21 frames
  padded to 32), one a rank; (dp 1, tp 4): one whole clip a step.  Two
  stochastic steps each, with JAX's own masks for the global batch
  (`test_torch_train_face.jax_face_masks`).  Rank 0 holds each step against
  the one-process step from the same state on the same global batch and
  masks, beside that step computed in another order, one row a forward or
  one clip twice in a batch (`torch_dist_check.face_spread_run`;
  `step_failures`: twice that spread or the FLOORS, and a step where a ReLU
  input within rounding of 0 took the other branch within KINKS); the
  losses and the
  gradient norm are within 1e-5 of JAX's step on the same global batches;
  the losses are bit-equal on every rank, and so is the whole state
  (generator and SGD momentum) after every step; the frozen extractor is
  whole and bit-unchanged on every rank.
- (dp 2, tp 2): one step with a planted fault (the last tp rank puts its
  parameter slices back) fails the check; one `--bf16` step with masks
  drawn in the step is held to the one-process bf16 step within
  tests/test_torch_bf16.py's bounds.
- (dp 1, tp 4): the face trainer's epoch (four whole clips, the masks drawn
  from its step generator) writes a whole checkpoint that loads on one
  device and equals the one-process trainer's within 1e-5 of the largest
  parameter (as tests/test_torch_train_face.py bounds the face step: a
  tensor's own largest is no scale for a LayerNorm bias that two updates
  moved from 0 to 1e-5, whose gradient is a cancelling sum) and its
  momentum within `torch_dist_check.KINKS`' gradient bound of the largest
  (a ReLU input within rounding of 0 may take the other branch), and
  resumes on the mesh bit for bit.
- The grouped column-parallel conv (768 channels in 16 groups) against the
  whole conv at tp 2 (whole groups a rank) and tp 3 (256 rows a rank, groups
  of 48): output, input, weight and bias gradients within 1e-5.
- The masks a mesh step draws from a generator are this rank's rows of the
  one-process draw for the global batch (no process group needed).
"""
import os
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train_face as tf
import torch_dist_check as sc
from talkshow_tpu.models import face as jface
from talkshow_tpu.models import wav2vec as jw2v
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert
from talkshow_torch.parallel.mesh import Mesh
from talkshow_torch.train.steps import draw_face_masks

WORLD, LAYOUTS, STEPS, EXTRA, TRAINER = 4, ("4x1", "1x4"), 2, "2x2", "1x4"
W = sc.FACE_WIDTHS["toy"]
N = int(16000 * W["seconds"])
T = N * 30 // 16000
#: the group's own timeout, in seconds
GROUP_TIMEOUT = 90.0


def _kind(layout: str) -> str:
    return "bucketed" if int(layout.split("x")[0]) > 1 else "whole"


def _in_thread(fn, *args) -> tuple:
    """Start fn(*args) in a thread -> (thread, [result or exception])."""
    box = []

    def run():
        try:
            box.append(fn(*args))
        except Exception as e:  # noqa: BLE001 -- re-raised by _joined
            box.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    return thread, box


def _joined(job):
    thread, box = job
    thread.join()
    if isinstance(box[0], Exception):
        raise box[0]
    return box[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's init, then in threads (JAX compiles outside the GIL) its face
    steps on the global batches of both kinds (they take the keys) and the
    recovery of its masks for them; the group runs from the converted init
    with JAX's masks as soon as they are written.  -> each rank's result,
    JAX's metrics per kind, the tmp dir, the fixture's wall seconds."""
    t0 = time.perf_counter()
    tmp = tmp_path_factory.mktemp("dist_face")
    face = jface.FaceGenerator(wav2vec_cfg=jw2v.Wav2Vec2Config(**W["cfg"]))
    init, step = jsteps.make_face_step(face, learning_rate=W["lr"], momentum=0.9,
                                       max_grad_norm=W["max_norm"], window=T)
    s0 = jax.jit(init, static_argnames=("samples_per_window", "window"))(
        jax.random.PRNGKey(0), samples_per_window=N, window=T)
    state_path = str(tmp / "state.pt")
    torch.save(convert.from_jax_face_state(jax.tree.map(np.asarray, s0)), state_path)
    data = {kind: sc.face_global_batches(W, STEPS, kind == "bucketed", seed=7 + i)
            for i, kind in enumerate(("whole", "bucketed"))}
    keys = {kind: [jax.random.PRNGKey(300 + 10 * i + s) for s in range(STEPS)]
            for i, kind in enumerate(data)}

    def jax_run(kind):
        state, out = s0, []
        for b, key in zip(data[kind], keys[kind]):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
            out.append({k: float(v) for k, v in m.items() if k != "nonfinite_skips"})
        return out

    def masks(kind):
        # the masks depend on the key and the shapes only
        return [tf.jax_face_masks(face, s0.params, b, key, frames=b["gt"].shape[1])
                for b, key in zip(data[kind], keys[kind])]

    steps = {kind: _in_thread(jax_run, kind) for kind in data}
    recovered = {kind: _in_thread(masks, kind) for kind in data}
    for kind, job in recovered.items():
        for b, (starts, keep) in zip(data[kind], _joined(job)):
            b["spec_starts"], b["drop_keep"] = starts, keep
    torch.save(data, str(tmp / "data.pt"))
    args = ["--face", *LAYOUTS, "--face_steps", str(STEPS), "--face_state", state_path,
            "--face_data", str(tmp / "data.pt"), "--face_fault", EXTRA, "--face_extra", EXTRA,
            "--face_trainer", TRAINER, "--device", "cpu", "--out", str(tmp),
            "--timeout", str(GROUP_TIMEOUT)]
    port = sc.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    sc.launch(lambda r: sc.rank_argv(r, WORLD, port, args), WORLD, GROUP_TIMEOUT, env)
    jax_metrics = {kind: _joined(job) for kind, job in steps.items()}
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return ranks, jax_metrics, tmp, time.perf_counter() - t0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_face_step_equals_one_process_step(run, layout):
    ranks = run[0]
    r0 = ranks[0]["face"][layout]
    dp, tp = (int(v) for v in layout.split("x"))
    assert r0["shape"] == {"dp": dp, "tp": tp} and len(r0["errors"]) == STEPS
    assert not sc.step_failures(r0), (layout, sc.step_failures(r0))
    # losses and the whole state (generator and momentum) bit-equal on every rank
    assert all(r["face"][layout]["losses"] == r0["losses"] for r in ranks)
    assert all(r["face"][layout]["fingerprints"] == r0["fingerprints"] for r in ranks)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_face_losses_and_grad_norm_match_jax(run, layout):
    ranks, jax_metrics = run[0], run[1]
    got = ranks[0]["face"][layout]["losses"]
    want = jax_metrics[_kind(layout)]
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == {"MSELoss", "exp_loss", "loss", "grad"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"{layout} step {s} {k}")
    assert want[0]["grad"] > W["max_norm"]      # the clip branch
    # the frozen extractor: K3's plain twin (whole clips) or the plain masked
    # extractor (buckets), once a step a rank
    assert all(r["face"][layout]["k3_plain"] == STEPS and r["face"][layout]["k3"] == 0
               for r in ranks)


def test_frozen_extractor_whole_and_unchanged_on_every_rank(run):
    ranks = run[0]
    fps = set()
    for r in ranks:
        for res in list(r["face"].values()) + [r["face_fault"], r["face_bf16"]]:
            ext = res["extractor"]
            assert ext["whole"] and ext["unchanged"] and not ext["requires_grad"]
            fps.add(ext["fingerprint"])
    assert len(fps) == 1        # every rank, every layout: JAX's init's bytes


def test_a_rank_that_skips_its_update_fails_the_face_check(run):
    r0 = run[0][0]["face_fault"]
    assert r0["shape"] == {"dp": 2, "tp": 2}
    bad = sc.step_failures(r0)
    assert bad and r0["errors"][0]["mesh"]["update_l2"] > 100 * r0["errors"][0]["f32"][
        "update_l2"], r0["errors"]


def test_bf16_face_step_on_a_mesh_matches_one_process(run):
    """tests/test_torch_bf16.py's face bounds: losses and the gradient norm
    within 1e-2 relative, the momentum within 0.1 of its largest, the f32
    masters within 0.1 lr x that largest."""
    ranks = run[0]
    e = ranks[0]["face_bf16"]["errors"][0]["mesh"]
    assert e["losses"] <= 1e-2 and e["grad_norm"] <= 1e-2, e
    assert e["momentum"] <= 0.1 and e["masters"] <= 0.1, e
    assert all(r["face_bf16"]["losses"] == ranks[0]["face_bf16"]["losses"] for r in ranks)
    assert all(r["face_bf16"]["fingerprints"] == ranks[0]["face_bf16"]["fingerprints"]
               for r in ranks)


def test_face_checkpoint_under_tp_loads_on_one_device(run):
    """The (dp 1, tp 4) trainer's ckpt-0.pt, written whole by rank 0, loads
    into a one-device FaceState and equals the one-process trainer's state
    (see the module doc for the bounds); it resumed on the mesh bit for
    bit."""
    ranks, _, tmp, _ = run
    assert all(r["face_trainer"]["steps"] == 4 and r["face_trainer"]["resumed_equal"]
               for r in ranks)
    # one thread, as each rank: with two, the CPU's GEMMs block their sums
    # otherwise, and over four steps ReLU inputs within rounding of 0 that
    # took the other branch move the momentum by 1e-3 of its largest
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = sc.face_trainer(str(tmp / "face_one"), W, "cpu", state_path=str(tmp / "state.pt"))
        one.train()
    finally:
        torch.set_num_threads(threads)
    state, _ = sc.face_state(W, "cpu")
    state.load_state_dict(torch.load(str(tmp / "face_run" / "ckpt-0.pt"),
                                     weights_only=False)["state"])
    got, want = sc.face_stats(state), sc.face_stats(one.state)
    for part, bound in (("face", 1e-5), ("momentum", sc.KINKS["grads"])):
        assert got["models"][part].keys() == want["models"][part].keys()
        top = max(w.abs().max().item() for w in want["models"][part].values())
        for k, w in want["models"][part].items():
            err = (got["models"][part][k] - w).abs().max().item()
            assert err <= bound * top, (part, k, err)
    for a, b in zip(ranks[0]["face_trainer"]["history"], one.history):
        for k in ("loss", "MSELoss", "exp_loss", "grad"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tp", [2, 3])
def test_grouped_conv_column_parallel(run, tp):
    ranks = run[0]
    rows = 768 // tp
    for r in ranks[:tp]:
        e = r["grouped_conv"][tp]
        assert e["rows"] == (rows, 48, 16)
        assert all(e[k] <= 1e-5 for k in ("forward", "input_grad", "weight_grad", "bias_grad")), e
    assert tp not in ranks[-1]["grouped_conv"]      # rank 3 sat both out


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2), (1, 4)])
def test_mesh_masks_are_rows_of_the_global_draw(dp, tp):
    B = 2
    grid = np.empty((dp, tp), dtype=object)
    grid[:] = torch.device("cpu")
    want = draw_face_masks(B * dp, T, 256, torch.Generator().manual_seed(5), "cpu")
    for rank in range(dp * tp):
        mesh = Mesh(grid, rank=rank)
        got = draw_face_masks(B, T, 256, torch.Generator().manual_seed(5), "cpu", mesh)
        rows = slice(mesh.dp_rank * B, (mesh.dp_rank + 1) * B)
        assert torch.equal(got[0], want[0][rows]) and torch.equal(got[1], want[1][rows])
    # a mask the batch brings is kept; the other is drawn as before
    spec = torch.zeros(B, 2, dtype=torch.long)
    got = draw_face_masks(B, T, 256, torch.Generator().manual_seed(5), "cpu", mesh, spec=spec)
    assert got[0] is spec and got[1].shape == (B, T, 256)

"""The port's dp x tp training steps in 4-process gloo groups on the CPU
(talkshow_torch/parallel, train/steps.py, train/trainer.py), against the
one-process step on the global batch and against JAX's one-device step.

Two groups of four ranks (tests/torch_dist_check.py, OMP_NUM_THREADS=1,
each joined with its own 90 s timeout that kills every rank).  The first
runs, from one body-VQ state converted from JAX (512 hidden, so that tp
splits weights as JAX's tests/test_trainer_parallel.py expects; 2048 x 64
codebooks), two steps under (dp 4, tp 1) and two under (dp 2, tp 2), then
one (dp 2, tp 2) step with a planted fault: the last tp rank never
updates its parameter slices.  The second runs one body-AE and one LS3DCG
step and two epochs of the body-pixel trainer with the token cache under
(dp 2, tp 2).

Rank 0 holds each body-VQ step against the one-process step from the same
state on the same global batch, beside that one-process step's own spread
under the batch's rows in reversed order (the same function summed in
another order; `torch_dist_check.step_errors`): the losses (relative;
also bit-equal on every rank), BatchNorm running statistics, EMA codebooks
and sums (over each tensor's largest), gradients (over the part's
largest: a conv bias under batch-statistics BatchNorm has a true gradient
of 0) and the parameters' changes (the share of elements off by more than
1e-2 lr, and the L2 error) lie within twice that spread or the floors
(`torch_dist_check.FLOORS`); a step that quantized a row to another code
than the reference (a nearest-code near-tie decided by rounding) is held
by its losses, within 1e-3, with at most 1e-2 of the rows moved and the
L2 error of its parameters' changes within 0.2 (`torch_dist_check.MOVED`,
`step_failures`).  The
spread is not always small: JAX's initial state has a hand-decoder
BatchNorm channel of variance 3e-4, whose backward amplifies rounding,
and there any two summation orders differ by 1e-3 of the gradients in L2.
Every rank holds the same state bit for bit after every step.  The
planted fault fails these bounds.

Against JAX: the global losses within 1e-5 of JAX's step on the same
batches, and rank 0's state after each step against JAX's converted state
after as many steps, within twice the one-process run's distance from it.
One body-AE and one LS3DCG step on (dp 2, tp 2) match their one-process
steps' losses and running statistics within 1e-5.  The pixel trainer's
cache hits in epoch 2 on every rank (no encode), and its ce per epoch
agrees with one process within 1e-5.
"""
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_check as sc
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.train import steps as jsteps
from talkshow_torch import convert

WORLD, LAYOUTS, STEPS, FAULT = 4, ("4x1", "2x2"), 2, "2x2"
W = sc.WIDTHS["toy"]
#: the group's own timeout, in seconds
GROUP_TIMEOUT = 90.0


def launch(tmp, args: list) -> tuple:
    """One group of WORLD ranks of torch_dist_check (joined with its own
    GROUP_TIMEOUT; every rank killed on failure or at the timeout):
    ([each rank's result], the group's wall seconds)."""
    port = sc.free_port()
    args = args + ["--device", "cpu", "--out", str(tmp), "--timeout", str(GROUP_TIMEOUT)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    sc.launch(lambda r: sc.rank_argv(r, WORLD, port, args), WORLD, GROUP_TIMEOUT, env)
    wall = time.perf_counter() - t0
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)], wall


def body_vq_run(tmp) -> tuple:
    """JAX's init and two steps on the global batches; the body-VQ group's
    results per rank and wall time; the one-process run's distance from
    JAX's states (`torch_dist_check.one_process_case`)."""
    vb = jv.VQVAE(in_dim=39, num_hiddens=W["num_hiddens"])
    vh = jv.VQVAE(in_dim=90, num_hiddens=W["num_hiddens"])
    init, step = jsteps.make_body_vq_step(vb, vh, learning_rate=W["lr"])
    state = jax.jit(init, static_argnames="window")(jax.random.PRNGKey(0), window=W["window"])
    torch.save(convert.from_jax_body_vq_state(jax.tree.map(np.asarray, state)),
               str(tmp / "state.pt"))
    jax_losses, jax_states = [], []
    for s, b in enumerate(sc.global_batches(W, STEPS)):
        state, m = step(state, {"poses": jnp.asarray(b)})
        jax_losses.append({k: float(v) for k, v in m.items() if k != "nonfinite_skips"})
        jax_states.append(str(tmp / f"jax{s}.pt"))
        torch.save(sc.jax_stats(W, convert.from_jax_body_vq_state(
            jax.tree.map(np.asarray, state))), jax_states[-1])
    ranks, wall = launch(tmp, ["--layouts", *LAYOUTS, "--steps", str(STEPS), "--width", "toy",
                               "--state", str(tmp / "state.pt"), "--jax_states", *jax_states,
                               "--fault", FAULT])
    one = sc.one_process_case(W, "cpu", str(tmp / "state.pt"), jax_states)
    for path in [str(tmp / "state.pt")] + jax_states:       # 70-220 MB each
        os.remove(path)
    return ranks, jax_losses, one, wall


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ranks, jax_losses, one, _ = body_vq_run(tmp_path_factory.mktemp("dist"))
    return ranks, jax_losses, one


@pytest.fixture(scope="module")
def pixel_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_pixel")
    return launch(tmp, ["--pixel", FAULT])[0], tmp


@pytest.mark.parametrize("layout", LAYOUTS)
def test_body_vq_step_equals_one_process_step(run, layout):
    ranks, _, _ = run
    r0 = ranks[0][layout]
    dp, tp = (int(v) for v in layout.split("x"))
    assert r0["shape"] == {"dp": dp, "tp": tp}
    assert len(r0["errors"]) == STEPS
    assert not sc.step_failures(r0), (layout, sc.step_failures(r0))
    # every rank holds the same state, bit for bit, after every step
    assert all(r[layout]["fingerprints"] == r0["fingerprints"] for r in ranks)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_body_vq_state_matches_jax(run, layout):
    """Rank 0's state after each step against JAX's after the same steps
    from the same state (`state_errors`: running statistics, codebooks
    and each parameter's change), within twice the one-process run's
    distance from JAX's or the floors.  After the first step that is
    1e-5 of each tensor's largest for the statistics and codebooks; after
    the second, the first step's moves of elements whose gradient is
    rounding noise (conv biases under batch-statistics BatchNorm, moved by
    lr with either sign) have reached the running means in both runs."""
    ranks, _, one = run
    for s, (mesh, one) in enumerate(zip(ranks[0][layout]["jax"], one)):
        for k in ("bn", "vq", "update_off", "update_l2"):
            assert mesh[k] <= max(sc.FLOORS[k], 2 * one[k]), (layout, s, k, mesh, one)


def test_a_rank_that_skips_its_update_fails_the_check(run):
    """The planted fault (the last tp rank never updates its parameter
    slices) fails the parameter-change bounds."""
    ranks, _, _ = run
    r0 = ranks[0]["fault"]
    bad = sc.step_failures(r0)
    # it would fail even as a step that moved rows to other codes
    assert bad and r0["errors"][0]["mesh"]["update_l2"] > sc.MOVED["update_l2"], r0["errors"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_losses_bit_equal_on_every_rank_and_match_jax(run, layout):
    ranks, jax_losses, _ = run
    losses = [r[layout]["losses"] for r in ranks]
    assert all(x == losses[0] for x in losses)
    for got, want in zip(losses[0], jax_losses):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{layout} {k}")
    # each quantizer searched this rank's rows once a step (K4's CPU twin)
    assert all(r[layout]["k4_plain"] == 2 * STEPS and r[layout]["k4"] == 0 for r in ranks)


@pytest.mark.parametrize("name", ["body_ae", "ls3dcg"])
def test_body_ae_and_ls3dcg_steps_equal_one_process_steps(pixel_run, name):
    """One step of each on (dp 2, tp 2): every loss within 1e-5 of the
    one-process f32 step's, and every BatchNorm running statistic (global
    batch statistics) within 1e-5 of its tensor's largest.  LS3DCG's `gen`
    reads the discriminator after its Adam update, which moves an element
    whose gradient is rounding noise by up to lr with either sign: 1e-4."""
    ranks, _ = pixel_run
    errs = ranks[0]["other"][name]
    assert all(v <= (1e-4 if k == "gen" else 1e-5) for k, v in errs.items()), (name, errs)


def test_pixel_trainer_token_cache_hits_on_every_rank(pixel_run):
    ranks, tmp = pixel_run
    assert [r["pixel"]["epoch2_encodes"] for r in ranks] == [0] * WORLD
    one = sc.pixel_trainer(str(tmp / "pixel_one"), "cpu")
    one.train(epochs=2)
    for r in ranks:
        got = [h["ce_loss"] for h in r["pixel"]["history"]]
        want = [h["ce_loss"] for h in one.history]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # rank 0 alone wrote the run's files
    assert sorted(os.listdir(tmp / "pixel")) == sorted(os.listdir(tmp / "pixel_one"))


def test_a_failed_rank_kills_the_group(tmp_path):
    """A rank that raises takes the group down at once, with its stderr."""
    port = sc.free_port()
    args = ["--layouts", "3x1", "--device", "cpu", "--out", str(tmp_path), "--timeout", "30"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with pytest.raises(RuntimeError, match="dp\\*tp=3 != global ranks 2"):
        sc.launch(lambda r: sc.rank_argv(r, 2, port, args), 2, 30.0, env)


@pytest.mark.slow
def test_full_width_dp_tp_step(tmp_path):
    """The same check at the reference's stage-1 width (1024 hidden, 2048 x
    64 codebooks, B = 128, T = 88) on (dp 2, tp 2), one step; chip_smoke's
    phase 34 runs it on the card at (dp 2, tp 1) and (dp 1, tp 2)."""
    port = sc.free_port()
    args = ["--layouts", "2x2", "--steps", "1", "--width", "full", "--device", "cpu",
            "--out", str(tmp_path), "--timeout", "1800"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    sc.launch(lambda r: sc.rank_argv(r, WORLD, port, args), WORLD, 1800.0, env)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    assert all(r["2x2"]["losses"] == ranks[0]["2x2"]["losses"] for r in ranks)
    assert not sc.step_failures(ranks[0]["2x2"]), sc.step_failures(ranks[0]["2x2"])

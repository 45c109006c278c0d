"""What the training drivers share: the train state built on the
benchmark's weights, a pool of synthetic batches on the device, the first
three steps that set-up drives and records, the window, and the check of
those steps against the reference.

Set-up builds one train state (modules, codebooks, optimizer) and drives it
through its first three steps on pool batches 0, 1, 2 (every row
different), by the same call the window makes; it records each step's loss,
the norm of each leaf's first gradient as the optimizer got it (Adam's
first moment after one step over 1 - beta1) and, after the third step, the
norm of each leaf's change.  The window then goes on stepping that same
state through the pool.

The check runs the reference's three steps from the same weights on the
same batches and compares, each the worst over steps or leaves:

- ``loss_gap``: |loss - reference loss| / |reference loss|;
- ``grad_gap``: | ||g|| - ||g_ref|| | / max(||g_ref||, the median leaf's);
- ``update_gap``: the same of each leaf's change after three steps (the
  EMA codebooks' too, in stage 1);
- ``grad_gap_median``, ``update_gap_median``: the median leaf's reading of
  the two above;
- ``token_mismatch`` (stage 2): the share of the cached token grids (the
  program's encode, K4) that differ from the reference's encode.

Leaves whose reference gradient is under a thousandth of the median leaf's
move under Adam by round-off alone and are left out of both leaf numbers."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import weights

BETA1 = 0.9
#: steps that set-up drives and the check replays
FIRST = 3


class State:
    pass


def smooth(shape, gen, device, low_hz=0.2, high_hz=3.0, fps=30.0, waves=4):
    """(..., T, C) smooth signals: sums of `waves` sinusoids a channel with
    random frequencies in [low_hz, high_hz], amplitudes and phases, plus a
    little noise, drawn on the device."""
    *lead, T, C = shape
    t = torch.arange(T, device=device, dtype=torch.float32)[:, None, None] / fps
    size = (*lead, 1, C, waves)
    f = low_hz + (high_hz - low_hz) * torch.rand(size, generator=gen, device=device)
    a = torch.rand(size, generator=gen, device=device) / waves
    ph = 2 * np.pi * torch.rand(size, generator=gen, device=device)
    x = (a * torch.sin(2 * np.pi * f * t + ph)).sum(-1)
    return x + 0.01 * torch.randn(shape, generator=gen, device=device)


def leaf_norms(named, fn) -> dict:
    return {n: float(fn(n, p).norm()) for n, p in named}


def first_steps(run, st) -> None:
    """Steps 1..FIRST on pool batches 0..FIRST-1 through `st.step` (which
    returns a function that reads the step's loss; the window never calls
    it, so it adds no wait for the device), with the recordings the check
    needs."""
    st.loss, named = [], st.named()
    for i in range(FIRST):
        st.loss.append(st.step(i)())
        if i == 0:
            # a leaf the optimizer has no moment for got no gradient: 0
            adam = st.optimizer.state
            st.grad1 = leaf_norms(named, lambda n, p: adam[p].get("exp_avg", torch.zeros(()))
                                  / (1 - BETA1))
    st.update = leaf_norms(named, lambda n, p: p.detach() - st.theta0[n])
    for name, (now, start) in st.books().items():
        st.update[name] = float((now - start).norm())


def window(run, st) -> None:
    """Steps through the pool until `run.seconds` have passed; the window
    ends with the step that crosses it, closed by a synchronize, so the rate
    covers all the work and all the time (a traced run's leaves out the
    pauses in which the profiler wrote its traces)."""
    from benchmark.trace import WindowProfile
    prof = WindowProfile(run.seconds, run.device == "cuda", run.tmp) if run.trace else None
    n = st.pool_size
    i = FIRST
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= run.seconds:
            break
        profiled = prof is not None and prof.tick(now - t0)
        with torch.profiler.record_function("span:train_step"):
            st.step(i % n)
        run.attempted += 1
        run.steps.append({"frames": st.frames, "profiled": profiled})
        i += 1
    sync()
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        run.profile = prof.finish()
        run.window_s -= prof.paused_s


def release(run, st) -> None:
    st.release()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    med = float(np.median([ref[k] for k in keep])) if keep else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def _leaf_gap(prog: dict, ref: dict, keep, median: bool = False) -> float:
    gaps = list(_leaf_gaps(prog, ref, keep).values())
    if not gaps:
        return 0.0
    return float(np.median(gaps)) if median else max(gaps)


def worst_leaves(st, ref_grad1, ref_update, n: int = 3) -> dict:
    """The leaves that read worst in each leaf number, with their readings
    and their reference norms (for the look behind a high reading)."""
    med = float(np.median(list(ref_grad1.values())))
    keep = [k for k, v in ref_grad1.items() if v >= 1e-3 * med]
    out = {}
    for name, prog, ref, ks in (("grad", st.grad1, ref_grad1, keep),
                                ("update", st.update, ref_update,
                                 keep + [k for k in ref_update if k.startswith("codebook.")])):
        gaps = _leaf_gaps(prog, ref, ks)
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[name] = [[k, gaps[k], prog[k], ref[k]] for k in top]
        out[name + "_median_ref"] = float(np.median([ref[k] for k in ks]))
    return out


def compare(st, ref_loss, ref_grad1, ref_update) -> dict:
    """The three (or four) numbers of the check, from the program's
    recordings `st` and the reference's."""
    med = float(np.median(list(ref_grad1.values())))
    keep = [k for k, v in ref_grad1.items() if v >= 1e-3 * med]
    moved = keep + [k for k in ref_update if k.startswith("codebook.")]
    out = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(st.loss, ref_loss))}
    for suffix, median in (("", False), ("_median", True)):
        out["grad_gap" + suffix] = _leaf_gap(st.grad1, ref_grad1, keep, median)
        out["update_gap" + suffix] = _leaf_gap(st.update, ref_update, moved, median)
    return out


def reference_readings(ref, st, batch, tokens=None) -> tuple:
    """The reference's losses, first-gradient and change norms over FIRST
    steps (`batch(i)` gives pool batch i; `tokens(i)` its token grids for
    stage 2)."""
    named = ref.named_parameters()
    theta0 = {n: p.detach().clone() for n, p in named}
    books0 = {k: v.clone() for k, v in ref.codebooks().items()}
    losses, grad1 = [], None
    for i in range(FIRST):
        if tokens is None:
            losses.append(ref.step(batch(i)))
        else:
            losses.append(ref.step(batch(i), tokens(i)))
        if i == 0:
            grad1 = {n: float(p.grad.norm()) for n, p in named}
    update = {n: float((p.detach() - theta0[n]).norm()) for n, p in named}
    for k, v in ref.codebooks().items():
        update[k] = float((v - books0[k]).norm())
    return losses, grad1, update


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def check(run, st, make_reference, tokens=None) -> list:
    """[(name, reading, limit)]; with the "control" hook the reference is
    also run with TF32 on (the precision below the configuration's float32)
    and compared with the float32 one, into run.extra["control"]."""
    limits = run.workload["limits"]
    ref = make_reference()
    r = reference_readings(ref, st, st.ref_batch, tokens)
    numbers = compare(st, *r)
    if run.hooks.get("diagnose"):
        run.extra["worst"] = worst_leaves(st, r[1], r[2])
        run.extra["loss"] = {"program": st.loss, "reference": r[0]}
    if tokens is not None:
        numbers["token_mismatch"] = st.token_mismatch(ref)
    if run.hooks.get("control") and run.device == "cuda":
        del ref
        tf32(True)
        try:
            ctl = reference_readings(make_reference(), st, st.ref_batch, tokens)
        finally:
            tf32(False)
        fake = State()
        fake.loss, fake.grad1, fake.update = ctl
        run.extra["control"] = compare(fake, *r)
        if tokens is not None:       # the control's encode against the reference's
            tf32(True)
            try:
                run.extra["control"]["token_mismatch"] = st.control_mismatch(make_reference())
            finally:
                tf32(False)
    return [(k, numbers[k], limits[k]) for k in limits]


def draw_gen(run, stream: int) -> torch.Generator:
    return torch.Generator(device=run.device).manual_seed(weights.seed63(run.seed, stream))

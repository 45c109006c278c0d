"""Multi-process checks of the port's dp x tp training steps, and their
launcher (tests/test_torch_parallel_dist.py, tests/test_torch_parallel_face.py
and chip_smoke.py's phases 34 and 37 run them).

    python tests/torch_dist_check.py --world 4 --layouts 4x1 2x2 \\
        --out DIR [--device cpu] [--width toy|full]

`launch` starts `world` ranks of this script (one process each; gloo over
localhost, several ranks may share one card; or nccl, a card per rank),
waits at most `timeout` seconds, kills every rank when one fails or time
runs out, and raises with the failed rank's stderr.  Each rank runs, for
every layout "DxP", the body-VQ step `steps` times from one state on one
global batch per step (`body_vq_case`), and writes what it saw to
<out>/rank<r>.pt: the global losses of each step, the K4 launches and step
times, a fingerprint of its whole state after each step, and (rank 0) each
step held against the one-process step from the same state on the same
global batch, beside that step's own spread over another row order of the
batch (`step_errors`).

`--final_state` (a converted JAX state after the same steps) holds rank
0's state after the last step against it.  `--fault LAYOUT` runs that
layout once more for one step with a planted fault: the last tp rank puts
its parameter slices back after the optimizer step, as a mesh that never
updates a slice would.  `--pixel LAYOUT` runs, on that layout, one
body-AE and one LS3DCG step against their one-process steps
(`other_steps_case`), then the body-pixel trainer with the token cache for
two epochs (`pixel_case`).  `--nccl_probe` checks one all_reduce in a
one-rank NCCL group.

The face step (stage 3; tests/test_torch_parallel_face.py and chip_smoke.py's
phase 37):

    python tests/torch_dist_check.py --world 4 --face 4x1 1x4 \\
        --face_fault 2x2 --face_extra 2x2 --face_trainer 1x4 --out DIR \\
        [--device cpu] [--face_width toy|full] [--face_state S] [--face_data D]

`--face` runs `face_case` on each layout "DxP", `--face_steps` steps from
one state (`--face_state`: a converted JAX face state) on global batches:
one whole clip a step where D = 1, else a bucketed batch of clips split
over dp; `--face_data` gives those batches with JAX's masks, else the
masks are drawn in the step from a generator seeded alike on every rank.
Rank 0 holds each step against the one-process step on the global batch
with the same global masks, beside that step computed in another order
(`face_spread_run`), and every rank writes its losses, its K3 and plain
extractor calls, fingerprints of its whole state and of its frozen
extractor.  `--face_fault LAYOUT` plants the fault above for one step;
`--face_extra LAYOUT` runs one `--bf16` face step there and then the
grouped column-parallel conv at tp 2 and 3 against the whole conv
(`grouped_conv_case`); `--face_trainer LAYOUT` the face trainer's epoch,
its checkpoint (<out>/face_run) and a resume on the mesh.
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: body-VQ widths: toy (CPU tests; 512 hidden, so that tp splits weights
#: as JAX's tests/test_trainer_parallel.py expects) and full (the
#: reference's stage 1: 1024 hidden, 2048 x 64 codebooks, B = 128, T = 88)
WIDTHS = {
    "toy": dict(num_hiddens=512, codes=2048, dim=64, batch=8, window=16, lr=1e-4),
    "full": dict(num_hiddens=1024, codes=2048, dim=64, batch=128, window=88, lr=1e-4),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_of_rank, world: int, timeout: float, env: dict | None = None) -> list:
    """Run `world` processes (argv_of_rank(r) each), all started together;
    returns their stdout.  Raises RuntimeError with the stderr of the first
    rank that failed, or of every rank when `timeout` seconds pass; every
    process is killed before it returns or raises."""
    procs, logs = [], []
    try:
        for r in range(world):
            out = tempfile.TemporaryFile()
            err = tempfile.TemporaryFile()
            logs.append((out, err))
            procs.append(subprocess.Popen(argv_of_rank(r), stdout=out, stderr=err, env=env))
        end = time.time() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.time() > end:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() is None or p.returncode != 0]
        if failed:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            bad = [r for r, p in enumerate(procs) if p.returncode not in (0, -9)] or failed
            msgs = []
            for r in bad:
                logs[r][1].seek(0)
                msgs.append(f"rank {r} (exit {procs[r].returncode}):\n"
                            + logs[r][1].read().decode(errors="replace")[-4000:])
            raise RuntimeError(f"{len(failed)} of {world} ranks failed or timed out after "
                               f"{timeout:.0f} s\n" + "\n".join(msgs))
        outs = []
        for out, _ in logs:
            out.seek(0)
            outs.append(out.read().decode(errors="replace"))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def rank_argv(rank: int, world: int, port: int, args: list) -> list:
    return [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
            "--world", str(world), "--port", str(port)] + args


# ---------------------------------------------------------------------------
# the body-VQ case
# ---------------------------------------------------------------------------

def global_batches(width: dict, steps: int, seed: int = 7) -> np.ndarray:
    """(steps, B, T, 129) conv-channel poses, alike on every rank."""
    rng = np.random.default_rng(seed)
    shape = (steps, width["batch"], width["window"], 129)
    return (rng.standard_normal(shape) * 0.2).astype(np.float32)


def body_vq_state(width: dict, device, state_path: str | None = None):
    """(state, step) of the body-VQ stage at these widths, from
    torch.Generator(0), or from a converted JAX state (`state_path`: a
    torch.save of convert.from_jax_body_vq_state's output)."""
    from talkshow_torch.models.vqvae import VQVAE
    from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
    from talkshow_torch.train.steps import make_body_vq_step
    init, step = make_body_vq_step(
        VQVAE(BODY_DIM, width["dim"], width["num_hiddens"]),
        VQVAE(HAND_DIM, width["dim"], width["num_hiddens"]), width["lr"], code_num=width["codes"])
    state = init(torch.Generator().manual_seed(0), device)
    if state_path:
        state.load_converted(torch.load(state_path, map_location="cpu", weights_only=False))
    return state, step


def models_of(state) -> dict:
    """{part: module} of a train state: a body state's `models`, or the
    face state's generator as "face"."""
    return state.models if hasattr(state, "models") else {"face": state.face}


def grads_of(state) -> dict:
    """{part: {name: gradient}} on the host (whole on a tp mesh) of every
    parameter that has one (a frozen one has none)."""
    from talkshow_torch.parallel.collectives import whole
    mesh = getattr(state, "mesh", None)
    return {part: {k: (whole(p.grad, mesh) if getattr(p, "tp_sharded", False)
                       else p.grad).detach().cpu().clone() for k, p in m.named_parameters()
                   if p.grad is not None}
            for part, m in models_of(state).items()}


def fingerprint(sd: dict) -> str:
    """A digest of the bytes of every tensor of a body-VQ state's models and
    codebooks: equal on ranks that hold the same state bit for bit."""
    h = hashlib.blake2b(digest_size=16)
    for group in ("models", "vq"):
        for part in sorted(sd[group]):
            for k in sorted(sd[group][part]):
                t = sd[group][part][k]
                if torch.is_tensor(t):
                    h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float | None = None) -> float:
    """max|a - b| over the scale (default max|b|; 1 for an all-zero b),
    in f64 on a's device."""
    scale = scale if scale is not None else b.abs().max().item()
    return (a.double() - b.to(a.device).double()).abs().max().item() / (scale or 1.0)


#: the EMA quantizer's decay (ops/vq.quantize_train)
VQ_DECAY = 0.99

#: an element of a parameter whose change in a step differs from the
#: reference's by more than this many lr is off
UPDATE_TOL = 1e-2


def state_errors(before: dict, after: dict, want: dict, names: dict, lr: float) -> dict:
    """The state a step (or several) left (`after`, a whole state_dict)
    against the reference's (`want`), both from `before`:
    - bn: running statistics, vq: codebooks and EMA sums, each over the
      tensor's largest;
    - update_off: the share of parameter elements (`names`: {part:
      parameter names}) whose change differs from the reference's by more
      than UPDATE_TOL lr.  Adam moves an element by about lr whatever its
      gradient's size, so one that a mesh updated wrongly or not at all is
      off; so is one whose gradient is rounding noise (a conv bias under
      batch-statistics BatchNorm), which Adam moves by lr with either sign;
    - update_l2: the largest over parts of |change - reference's| over
      |reference's change| in L2."""
    out = {"bn": max((_rel(after["models"][part][k], v) for part, sd in want["models"].items()
                      for k, v in sd.items() if k.endswith(("running_mean", "running_var"))),
                     default=0.0),
           "vq": max((_rel(after["vq"][part][k], v) for part, st in want["vq"].items()
                      for k, v in st.items() if torch.is_tensor(v) and v.is_floating_point()),
                     default=0.0)}
    off = n = 0
    out["update_l2"] = 0.0
    for part, ks in names.items():
        sq = ref_sq = 0.0
        for k in ks:
            # f32 differences of nearby values are exact; sums in f64
            start = before["models"][part][k]
            ref = want["models"][part][k].to(start.device) - start
            d = (after["models"][part][k] - start - ref).abs()
            off += int((d > UPDATE_TOL * lr).sum())
            n += d.numel()
            sq += float((d * d).sum(dtype=torch.float64))
            ref_sq += float((ref * ref).sum(dtype=torch.float64))
        out["update_l2"] = max(out["update_l2"], (sq / ref_sq) ** 0.5)
    out["update_off"] = off / n
    return out


def _errors(ref: tuple, before: dict, after: dict, losses: dict, grads: dict,
            names: dict, lr: float) -> dict:
    """A step's result (`after`: its whole state_dict, `losses`, `grads`)
    against the reference step's (state_dict, losses, grads)."""
    ref_sd, ref_losses, ref_grads = ref
    out = {"losses": max(_rel(torch.tensor(losses[k]), torch.tensor(v))
                         for k, v in ref_losses.items() if k != "grad"),
           "grad_norm": (_rel(torch.tensor(losses["grad"]), torch.tensor(ref_losses["grad"]))
                         if "grad" in ref_losses else 0.0)}
    out["grads"] = 0.0
    sq = ref_sq = 0.0
    for part, gs in ref_grads.items():
        top = max(x.abs().max().item() for x in gs.values())
        for k, g in gs.items():
            d = (grads[part][k] - g).abs()
            out["grads"] = max(out["grads"], d.max().item() / top)
            sq += float((d * d).sum(dtype=torch.float64))
            ref_sq += float((g * g).sum(dtype=torch.float64))
    out["grads_l2"] = (sq / ref_sq) ** 0.5
    out.update(state_errors(before, after, ref_sd, names, lr))
    # rows quantized to another code than the reference's: the step's code
    # counts are (new - decay * old) / (1 - decay) of the EMA count, and
    # both steps start from one state
    out["moves"] = sum(round(float((after["vq"][part]["ema_count_hidden"].double().cpu()
                                    - st["ema_count_hidden"].double().cpu()).abs().sum())
                             / (1 - VQ_DECAY) / 2) for part, st in ref_sd["vq"].items())
    return out


def _stats(sd: dict) -> dict:
    """A copy of a body-VQ state_dict's models and codebooks (what the
    errors read; the optimizer's moments are left out)."""
    return copy.deepcopy({k: sd[k] for k in ("models", "vq")})


def param_names(state) -> dict:
    """{part: names of the trained parameters}."""
    return {part: [k for k, p in m.named_parameters() if p.requires_grad]
            for part, m in models_of(state).items()}


def reference_runs(before: dict, ref_state, ref_step, batch: torch.Tensor) -> list:
    """The one-process step (`ref_step` on `ref_state`) from `before` (a
    whole state_dict) on the global batch, then on its rows in reversed
    order: [(models and codebooks, losses, grads)] of each."""
    runs = []
    for rows in (torch.arange(batch.shape[0]), torch.arange(batch.shape[0] - 1, -1, -1)):
        ref_state.load_state_dict(copy.deepcopy(before))
        ref_state, m = ref_step(ref_state, {"poses": batch[rows.to(batch.device)]})
        runs.append((_stats(ref_state.state_dict()),
                     {k: float(v) for k, v in m.items() if k != "nonfinite_skips"},
                     grads_of(ref_state)))
    return runs


def step_errors(before: dict, after: dict, losses: dict, grads: dict, runs: list, names: dict,
                lr: float) -> dict:
    """The mesh's step (`after`: its whole state_dict, its global `losses`
    and reduced `grads`) against the one-process step from `before` (a
    whole state_dict) on the global batch, beside that one-process step run
    on the batch's rows in reversed order (`runs`: `reference_runs`).
    Reordered, the step computes the same function summed in another
    order, so the reordered run's distance from the reference is what f32
    arithmetic determines of this step, and the mesh's sums are one more
    order.  It is not always small: a BatchNorm channel whose variance is
    small beside its mean makes the backward amplify rounding (one at 3e-4
    in the hand decoder of JAX's initial state moves 1e-3 of the gradients
    in L2 on the CPU), and at full width a nearest-code near-tie can go
    either way.

    Returns {"mesh": errors, "f32": the reordered run's errors}, errors
    being `state_errors`' and:
    - losses: relative (the gradients' global norm, where the step reports
      one, apart as grad_norm);
    - grads: over the part's largest gradient (a conv bias under
      batch-statistics BatchNorm has a true gradient of 0, so its own
      largest is rounding noise); grads_l2, the relative L2 error;
    - moves: the rows quantized to another code than the reference's (a
      nearest-code near-tie that a rounding difference decides; such a
      step's gradients and codebook differ by the moved rows)."""
    return {"mesh": _errors(runs[0], before, after, losses, grads, names, lr),
            "f32": _errors(runs[0], before, *runs[1], names, lr)}


def body_vq_case(dp: int, tp: int, width: dict, device, steps: int, state_path: str | None,
                 jax_paths: list = (), fault: bool = False, first_runs: list | None = None) -> dict:
    """This rank's run of `steps` body-VQ steps on a (dp, tp) mesh: global
    losses, K4 launches, step times and state fingerprints; rank 0 also
    holds every step against the one-process step from the same state
    (`step_errors`), and its state after step s against JAX's
    (`jax_paths[s]`, a converted state after the same steps;
    `state_errors` from the first state).  `fault`: the last tp rank puts
    its parameter slices back after every optimizer step.  `first_runs`:
    rank 0's `reference_runs` of the first step, shared by the cases that
    start from one state (filled by the first)."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.parallel.collectives import _sharded_params, shard_state, unsharded
    from talkshow_torch.parallel.multihost import global_mesh, make_global_batch
    mesh = global_mesh(dp, tp, device=device)
    state, step = body_vq_state(width, mesh.device, state_path)
    shard_state(mesh, state)
    if mesh.rank == 0:
        ref_state, ref_step = body_vq_state(width, mesh.device)
    batches = global_batches(width, steps)
    out = {"losses": [], "ms": [], "errors": [], "fingerprints": [], "k4": 0, "k4_plain": 0,
           "shape": mesh.shape, "rows": 2 * width["batch"] * width["window"] // 4}
    first, afters = None, []
    for s in range(steps):
        with unsharded(state):
            before = copy.deepcopy(state.state_dict()) if mesh.rank == 0 else None
        if s == 0:
            first = before
        local = make_global_batch(mesh, {"poses": batches[s]})
        planted = fault and mesh.tp_rank == mesh.tp - 1
        kept = [p.detach().clone() for p in _sharded_params(state)] if planted else []
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        n4, p4, t0 = counts["nearest_code"], counts["nearest_code_plain"], time.perf_counter()
        state, m = step(state, local)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["k4"] += counts["nearest_code"] - n4
        out["k4_plain"] += counts["nearest_code_plain"] - p4
        with torch.no_grad():
            for p, k in zip(_sharded_params(state), kept):
                p.copy_(k)
        loss = {k: float(v) for k, v in m.items() if k != "nonfinite_skips"}
        out["losses"].append(loss)
        grads = grads_of(state)
        with unsharded(state):
            sd = state.state_dict()
            out["fingerprints"].append(fingerprint(sd))
            after = _stats(sd) if mesh.rank == 0 else None
        if mesh.rank == 0:
            if jax_paths:
                afters.append(after)
            if s or not first_runs:
                runs = reference_runs(before, ref_state, ref_step,
                                      torch.as_tensor(batches[s], device=mesh.device))
                if s == 0 and first_runs is not None:
                    first_runs.extend(runs)
            else:
                runs = first_runs
            out["errors"].append(step_errors(before, after, loss, grads, runs,
                                             param_names(ref_state), width["lr"]))
    if mesh.rank == 0 and jax_paths:
        out["jax"] = against_jax(first, afters, jax_paths, param_names(ref_state), width["lr"])
    return out


def against_jax(first: dict, afters: list, jax_paths: list, names: dict, lr: float) -> list:
    """`state_errors` of each state in `afters` (from `first`) against
    JAX's after as many steps (`jax_paths`: `jax_stats` files)."""
    return [state_errors(first, after, torch.load(path, weights_only=False), names, lr)
            for after, path in zip(afters, jax_paths)]


def jax_stats(width: dict, converted: dict) -> dict:
    """A converted JAX body-VQ state (convert.from_jax_body_vq_state) as
    the models and codebooks of a port state_dict (`_stats`)."""
    state, _ = body_vq_state(width, "cpu")
    state.load_converted(converted)
    return _stats(state.state_dict())


def one_process_case(width: dict, device, state_path: str, jax_paths: list) -> list:
    """The one-process body-VQ run from the same state on the same global
    batches, held against JAX's after each step as `body_vq_case` holds
    the mesh's."""
    state, step = body_vq_state(width, device, state_path)
    first = copy.deepcopy(state.state_dict())
    afters = []
    for batch in global_batches(width, len(jax_paths)):
        state, _ = step(state, {"poses": torch.as_tensor(batch, device=device)})
        afters.append(_stats(state.state_dict()))
    return against_jax(first, afters, jax_paths, param_names(state), width["lr"])


#: the bound of each error where twice the row-order spread is smaller
FLOORS = dict(losses=1e-5, grad_norm=1e-5, bn=1e-5, vq=1e-5, grads=1e-5, grads_l2=1e-5,
              update_off=1e-3, update_l2=1e-2)

#: a step that moved rows to other codes: at most this share of the rows
#: moved, its losses within 1e-3, and the L2 error of its parameters'
#: changes within 0.2.  One moved row of 5632 changes the gradients by
#: 5.7e-2 in L2, and so the Adam update of 15 % of the elements by more
#: than 1e-2 lr (L2 4.1e-2; full width on the card), where a slice left
#: un-updated reads 0.62 and a wrong step size 1.0 or more
MOVED = dict(rows=1e-2, losses=1e-3, update_l2=2e-1)


#: a face step in which a ReLU input within rounding of 0 took the other
#: branch on the mesh than in the reference (a tp slice's GEMM or a dp
#: rank's one-row batch sums in another order): the function is continuous
#: there, so the losses stay at their floor, but that element's gradient,
#: and so the gradients' norm, moves.  The face loss is a mean over a few
#: thousand elements, so one element's gradient weighs far more than in
#: the body-VQ step's mean.  Seen: one flip in the expression head of the
#: toy model moved the gradients by 8.7e-5 of the largest (5.9e-5 in L2) on
#: the CPU; at full width on the card, the fourth (dp 1, tp 2) step read
#: 1.2e-3 (9.9e-4 in L2, its norm 8.7e-5), the same step computed in
#: another order 6.7e-4 (3.9e-4), with the losses within 1.2e-7.  A tp
#: slice left un-updated reads 0.33 (toy) and 0.63 (full) in update_l2
KINKS = dict(losses=FLOORS["losses"], grad_norm=1e-2, grads=1e-2, grads_l2=1e-2,
             update_off=FLOORS["update_off"], update_l2=1e-2)


def step_failures(result: dict) -> list:
    """The steps of one layout's result that miss their bounds: every error
    within twice the row-order spread or its FLOORS entry; a step that
    moved rows to other codes within MOVED; a face step (`result["relu"]`)
    that misses those bounds within KINKS."""
    bad = []
    for s, errors in enumerate(result["errors"]):
        e, spread = errors["mesh"], errors["f32"]
        if e["moves"]:
            ok = (e["moves"] <= MOVED["rows"] * result["rows"] and e["losses"] <= MOVED["losses"]
                  and e["update_l2"] <= MOVED["update_l2"])
        else:
            ok = all(e[k] <= max(floor, 2 * spread[k]) for k, floor in FLOORS.items())
            if not ok and result.get("relu"):
                ok = all(e[k] <= max(bound, 2 * spread[k]) for k, bound in KINKS.items())
        if not ok:
            bad.append(f"step {s}: mesh {e}, row-order spread {spread}")
    return bad


# ---------------------------------------------------------------------------
# the body-AE and LS3DCG steps
# ---------------------------------------------------------------------------

def other_steps_case(dp: int, tp: int, device) -> dict:
    """One body-AE step (512 hidden) and one LS3DCG step (its fixed widths)
    on a (dp, tp) mesh from one state, B = 8, T = 16; rank 0 holds each
    against the one-process f32 step from the same state on the same
    global batch: {step: {loss name: relative error, "bn": the largest
    BatchNorm running-statistic error over its tensor's largest}}."""
    from talkshow_torch.models.ls3dcg import LS3DCGDiscriminator, LS3DCGGenerator
    from talkshow_torch.models.vqvae import AE
    from talkshow_torch.parallel.collectives import shard_state, unsharded
    from talkshow_torch.parallel.multihost import global_mesh, make_global_batch
    from talkshow_torch.train.steps import make_body_ae_step, make_ls3dcg_step
    mesh = global_mesh(dp, tp, device=device)
    rng = np.random.default_rng(11)
    batch = {"poses": (rng.standard_normal((8, 16, 165)) * 0.2).astype(np.float32),
             "expression": (rng.standard_normal((8, 16, 100)) * 0.3).astype(np.float32),
             "aud_feat": rng.standard_normal((8, 16, 64)).astype(np.float32)}
    makers = {"body_ae": lambda: make_body_ae_step(AE(129, num_hiddens=512)),
              "ls3dcg": lambda: make_ls3dcg_step(LS3DCGGenerator(), LS3DCGDiscriminator())}
    out = {}
    for name, make in makers.items():
        init, step = make()
        state = init(torch.Generator().manual_seed(1), mesh.device)
        shard_state(mesh, state)
        state, m = step(state, make_global_batch(mesh, batch))
        with unsharded(state):
            after = copy.deepcopy(state.state_dict()) if mesh.rank == 0 else None
        if mesh.rank == 0:
            init, ref_step = make()
            ref = init(torch.Generator().manual_seed(1), mesh.device)
            ref, rm = ref_step(ref, {k: torch.as_tensor(v, device=mesh.device)
                                     for k, v in batch.items()})
            errs = {k: _rel(torch.tensor(float(m[k])), torch.tensor(float(v)))
                    for k, v in rm.items() if k != "nonfinite_skips"}
            got, want = _module_dicts(after), _module_dicts(ref.state_dict())
            errs["bn"] = max(_rel(got[k], v) for k, v in want.items()
                             if k.endswith(("running_mean", "running_var")))
            out[name] = errs
    return out


def _module_dicts(sd: dict) -> dict:
    """A train state's state_dict -> {module.name: tensor} of its modules."""
    mods = sd.get("models") or {"model": sd["model"]}
    return {f"{k}.{n}": v for k, m in mods.items() for n, v in m.items()}


# ---------------------------------------------------------------------------
# the body-pixel trainer with the token cache
# ---------------------------------------------------------------------------

PIXEL = dict(batch=8, window=16, codes=512, vq_hidden=32, dim=16, layers=3, audio=32)


def pixel_trainer(run_dir: str, device, dp: int = 1, tp: int = 1):
    """A body-pixel Trainer at toy widths (frozen VQs and the prior from
    fixed seeds, synthetic windows), with the token cache, on a (dp, tp)
    mesh of the process group when dp * tp > 1."""
    from talkshow_torch.config import body_pixel_config
    from talkshow_torch.data.dataset import synthetic_dataset
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
    from talkshow_torch.ops.vq import init_vq_state
    from talkshow_torch.train.steps import make_body_pixel_step, make_token_encoder
    from talkshow_torch.train.trainer import Trainer
    cfg = body_pixel_config()
    cfg.train.batch_size, cfg.train.epochs = PIXEL["batch"], 2
    cfg.data.pose.generate_length = PIXEL["window"]
    cfg.log.print_every, cfg.log.save_every = 2, 1
    cfg.parallel.dp, cfg.parallel.tp = dp, tp
    ds = synthetic_dataset(num_clips=2, frames=100)
    ds.generate_length = PIXEL["window"]
    gen = torch.Generator().manual_seed(3)
    vqs = [init_weights_(VQVAE(c, 64, PIXEL["vq_hidden"]), gen).eval()
           for c in (BODY_DIM, HAND_DIM)]
    states = {k: init_vq_state(gen, PIXEL["codes"], 64, "cpu") for k in ("body", "hand")}
    # 512 codes and the 512-wide head: the embedding, out_hidden and
    # out_logits split over tp
    prior = GatedPixelCNN(input_dim=PIXEL["codes"], dim=PIXEL["dim"], n_layers=PIXEL["layers"],
                          audio_channels=PIXEL["audio"])
    init, step = make_body_pixel_step(prior, AudioEncoder(num_hiddens=PIXEL["audio"]), *vqs,
                                      states)
    enc = make_token_encoder(*vqs, states)
    return Trainer(cfg, ds, init, step, run_dir=run_dir, device=device, needs_rng=True,
                   batch_keys=("poses", "aud_feat", "speaker"), token_encoder=enc).setup()


def pixel_case(run_dir: str, device, dp: int, tp: int) -> dict:
    """Epoch 1, then epoch 2 with the encoder's calls counted."""
    tr = pixel_trainer(run_dir, device, dp, tp)
    tr.train(epochs=1)
    calls = []
    enc = tr.token_encoder

    def counted(poses):
        calls.append(poses.shape[0])
        return enc(poses)

    tr.token_encoder = counted
    tr.train(epochs=2)
    return {"history": tr.history, "epoch2_encodes": len(calls),
            "cached": len(tr._token_cache)}


# ---------------------------------------------------------------------------
# the face step (stage 3)
# ---------------------------------------------------------------------------

#: face-step widths: toy (CPU tests: 512 hidden, 8 heads, FFN 1024, a
#: 512-channel first extractor conv and a 512-wide positional conv of 16
#: taps in 16 groups, so that tp splits what JAX shards, a frozen weight
#: included; 1 s clips) and full (wav2vec 2.0 base with the face heads on
#: 8 s clips).  `batch`: the global batch of a bucketed layout (dp > 1),
#: padded to `bucket` frames; whole clips run at batch 1.
FACE_WIDTHS = {
    "toy": dict(cfg=dict(hidden_size=512, num_layers=2, num_heads=8, intermediate_size=1024,
                         conv_dim=(512, 64), conv_kernel=(10, 3), conv_stride=(5, 2),
                         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=16),
                seconds=1.0, batch=4, bucket=32, lr=1e-3, max_norm=1.0),
    "full": dict(cfg={}, seconds=8.0, batch=2, bucket=32, lr=1e-3, max_norm=5.0),
}
#: audio samples per frame, rounded up (data/dataset.face_batches)
SAMPLES_PER_FRAME = -(-16000 // 30)
#: the seed of step s's mask generator is FACE_SEED + s
FACE_SEED = 100


def face_state(width: dict, device, state_path: str | None = None, dtype=None):
    """(state, step) of the stochastic face stage at these widths (compute
    dtype `dtype`: None for f32, or bf16 as `--bf16`), from
    torch.Generator(0), or from a converted JAX state (`state_path`: a
    torch.save of convert.from_jax_face_state's output)."""
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    from talkshow_torch.train.steps import make_face_step
    init, step = make_face_step(FaceGenerator(Wav2Vec2Config(**width["cfg"], dtype=dtype)),
                                width["lr"], 0.9, width["max_norm"])
    state = init(torch.Generator().manual_seed(0), device)
    if state_path:
        state.load_converted(torch.load(state_path, map_location="cpu", weights_only=False))
    return state, step


def face_global_batches(width: dict, steps: int, bucketed: bool, seed: int = 7) -> list:
    """`steps` global face batches (numpy), alike on every rank: one whole
    clip, or `width["batch"]` clips of 3 frames fewer each padded to the
    bucket, with valid_samples / valid_frames as face_batches gives them."""
    rng = np.random.default_rng(seed)
    N = int(16000 * width["seconds"])
    T = N * 30 // 16000
    B = width["batch"] if bucketed else 1
    out = []
    for _ in range(steps):
        ids = np.zeros((B, 4), np.float32)
        ids[np.arange(B), np.arange(B) % 4] = 1.0
        wav = rng.standard_normal((B, N)).astype(np.float32)
        gt = (0.3 * rng.standard_normal((B, T, 265))).astype(np.float32)
        if not bucketed:
            out.append({"waveform": wav, "id_onehot": ids, "gt": gt})
            continue
        tb = -(-T // width["bucket"]) * width["bucket"]
        frames = np.array([T - 3 * j for j in range(B)], np.int32)
        samples = (frames * 16000 // 30).astype(np.int32)
        pwav = np.zeros((B, tb * SAMPLES_PER_FRAME), np.float32)
        pgt = np.zeros((B, tb, 265), np.float32)
        for j in range(B):
            pwav[j, :samples[j]] = wav[j, :samples[j]]
            pgt[j, :frames[j]] = gt[j, :frames[j]]
        out.append({"waveform": pwav, "id_onehot": ids, "gt": pgt, "valid_samples": samples,
                    "valid_frames": frames})
    return out


def face_stats(state) -> dict:
    """A copy of a face state's generator and SGD momentum (whole on a tp
    mesh inside `unsharded`) in the layout `state_errors` reads: parts
    "face" and "momentum", no codebooks."""
    sgd = state.optimizer.inner
    mom = {k: sgd.state[p]["momentum_buffer"] for k, p in state.face.named_parameters()
           if "momentum_buffer" in sgd.state.get(p, {})}
    return copy.deepcopy({"models": {"face": state.face.state_dict(), "momentum": mom},
                          "vq": {}})


def _face_extra_errors(after: dict, ref: dict, lr: float) -> dict:
    """The bounds tests/test_torch_bf16.py reads: the momentum's error over
    the reference's largest, the parameters' (masters') over lr times it."""
    top = max((v.abs().max().item() for v in ref["models"]["momentum"].values()), default=0.0)
    mom = max((_rel(after["models"]["momentum"][k], v, top or 1.0)
               for k, v in ref["models"]["momentum"].items()), default=0.0)
    masters = max(_rel(after["models"]["face"][k], v, lr * (top or 1.0))
                  for k, v in ref["models"]["face"].items())
    return {"momentum": mom, "masters": masters}


def face_spread_run(ref_state, batch: dict) -> tuple:
    """The one-process face step on the global batch (a dict of tensors
    with its masks) computed in another order: for several rows, the
    forward and backward taken one row at a time, last row first, the
    gradients summed before the clip and the SGD step (one row a forward is
    what a dp rank of one row runs); for one row, that row twice in one
    batch (other GEMM shapes).  Both are the same function as the step: its
    losses are sums over the rows divided by the count of their frames.
    The distance of this run from the step is what f32 rounding makes of
    this step; in particular a ReLU whose input lies within rounding of 0
    may take the other branch here, as on the mesh (one in the expression
    head moved that conv's gradient by 6.5e-4 of the largest on the CPU at
    toy width), which reversing the rows of a batch never shows.
    -> (face_stats, losses, grads)."""
    from talkshow_torch.models.wav2vec_fused import frozen_features
    model, opt = ref_state.face.train(), ref_state.optimizer
    B, T = batch["gt"].shape[:2]
    chunks = [[r] for r in range(B - 1, -1, -1)] if B > 1 else [[0, 0]]
    vf = batch.get("valid_frames")
    n = sum(float(vf[c].sum()) if vf is not None else float(len(c) * T) for c in chunks)
    opt.zero_grad()
    l1_sum = mse_sum = 0.0
    for rows in chunks:
        x = {k: v[rows] for k, v in batch.items()}
        vs = x.get("valid_samples")
        feats = frozen_features(model.audio_encoder, x["waveform"], vs, tables=ref_state.tables)
        pred = model.train_forward(feats, x["id_onehot"], T, vs, x.get("valid_frames"),
                                   x["spec_starts"], x["drop_keep"])
        gt = x["gt"]
        m = torch.ones_like(gt[..., :1]) if vf is None else (
            torch.arange(T, device=gt.device)[None, :, None] < x["valid_frames"][:, None, None]
        ).to(pred.dtype)
        d6, d100 = pred[..., :6] - gt[..., :6], pred[..., -100:] - gt[..., -100:]
        l1, mse = (d6.abs() * m).sum() / (n * 6), (d100 * d100 * m).sum() / (n * 100)
        (l1 + mse).backward()
        l1_sum, mse_sum = l1_sum + l1.detach(), mse_sum + mse.detach()
    norm = opt.grad_norm()
    opt.step(norm)
    ref_state.step += 1
    losses = {"MSELoss": float(l1_sum), "exp_loss": float(mse_sum),
              "loss": float(l1_sum + mse_sum), "grad": float(norm)}
    return face_stats(ref_state), losses, grads_of(ref_state)


def face_reference_runs(before: dict, ref_state, ref_step, batch: dict) -> list:
    """[the one-process step on the global batch, `face_spread_run`],
    each from `before` (a whole state_dict): (face_stats, losses, grads)."""
    ref_state.load_state_dict(copy.deepcopy(before))
    ref_state, m = ref_step(ref_state, batch)
    runs = [(face_stats(ref_state), {k: float(v) for k, v in m.items() if k != "nonfinite_skips"},
             grads_of(ref_state))]
    ref_state.load_state_dict(copy.deepcopy(before))
    return runs + [face_spread_run(ref_state, batch)]


def face_case(dp: int, tp: int, width: dict, device, steps: int, state_path: str | None = None,
              data: list | None = None, fault: bool = False, dtype=None) -> dict:
    """This rank's run of `steps` face steps on a (dp, tp) mesh from one
    state, on global batches (`data`, numpy with the masks JAX drew,
    `spec_starts` and `drop_keep`; default `face_global_batches`, bucketed
    where dp > 1, the masks drawn in the step from a generator seeded
    FACE_SEED + s on every rank): global losses, K3 and plain-extractor
    calls, step times, fingerprints of the whole generator and momentum, the
    frozen extractor's shapes and bytes; rank 0 also holds every step
    against the one-process step from the same state on the global batch
    with the global masks (the one-process masks drawn for the global batch
    from the same seed), beside that step computed in another order
    (`face_reference_runs`; `step_errors` with `face_spread_run` as the
    spread), plus `_face_extra_errors`.
    `fault`: the last tp rank puts its parameter slices back after every
    optimizer step."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.parallel.collectives import _sharded_params, shard_state, unsharded
    from talkshow_torch.parallel.multihost import global_mesh, make_global_batch
    from talkshow_torch.train.steps import draw_face_masks
    mesh = global_mesh(dp, tp, device=device)
    state, step = face_state(width, mesh.device, state_path, dtype)
    ext = state.face.audio_encoder.feature_extractor
    whole_shapes = {k: tuple(v.shape) for k, v in ext.state_dict().items()}
    shard_state(mesh, state)
    ext_bytes = fingerprint({"models": {"ext": ext.state_dict()}, "vq": {}})
    if mesh.rank == 0:
        ref_state, ref_step = face_state(width, mesh.device, dtype=dtype)
    batches = data or face_global_batches(width, steps, dp > 1)
    width_keep = state.face.audio_feature_map.out_features
    out = {"losses": [], "ms": [], "errors": [], "fingerprints": [], "k3": 0, "k3_plain": 0,
           "shape": mesh.shape, "relu": True}
    for s in range(steps):
        with unsharded(state):
            before = copy.deepcopy(state.state_dict()) if mesh.rank == 0 else None
        gbatch = batches[s]
        local = make_global_batch(mesh, gbatch)
        gen = None
        if "spec_starts" not in gbatch:
            gen = torch.Generator(device=mesh.device).manual_seed(FACE_SEED + s)
        planted = fault and mesh.tp_rank == mesh.tp - 1
        kept = [p.detach().clone() for p in _sharded_params(state)] if planted else []
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        n3, p3, t0 = counts["wav2vec_extractor"], counts["extractor_plain"], time.perf_counter()
        state, m = step(state, local, gen)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["k3"] += counts["wav2vec_extractor"] - n3
        out["k3_plain"] += counts["extractor_plain"] - p3
        with torch.no_grad():
            for p, k in zip(_sharded_params(state), kept):
                p.copy_(k)
        loss = {k: float(v) for k, v in m.items() if k != "nonfinite_skips"}
        out["losses"].append(loss)
        grads = grads_of(state)
        with unsharded(state):
            after = face_stats(state)
        out["fingerprints"].append(fingerprint(after))
        if mesh.rank == 0:
            ref_batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in gbatch.items()}
            if gen is not None:
                B, T = gbatch["gt"].shape[:2]
                ref_batch["spec_starts"], ref_batch["drop_keep"] = draw_face_masks(
                    B, T, width_keep, torch.Generator(device=mesh.device).manual_seed(
                        FACE_SEED + s), mesh.device)
            runs = face_reference_runs(before, ref_state, ref_step, ref_batch)
            start = {"models": {"face": before["face"]}, "vq": {}}
            errors = step_errors(start, after, loss, grads, runs, {"face": param_names(
                ref_state)["face"]}, width["lr"])
            errors["mesh"].update(_face_extra_errors(after, runs[0][0], width["lr"]))
            errors["f32"].update(_face_extra_errors(runs[1][0], runs[0][0], width["lr"]))
            out["errors"].append(errors)
    out["extractor"] = {
        "whole": {k: tuple(v.shape) for k, v in ext.state_dict().items()} == whole_shapes,
        "unchanged": fingerprint({"models": {"ext": ext.state_dict()}, "vq": {}}) == ext_bytes,
        "fingerprint": ext_bytes, "requires_grad": any(p.requires_grad for p in ext.parameters())}
    return out


def face_trainer(run_dir: str, width: dict, device, dp: int = 1, tp: int = 1,
                 state_path: str | None = None):
    """A face-stage Trainer at these widths from `face_state` (converted
    from JAX when `state_path` is given), one epoch over four synthetic
    clips of width["seconds"], a checkpoint at its end, on a (dp, tp) mesh
    of the process group when dp * tp > 1: whole clips at batch 1, or
    under dp > 1 the clips in one 64-frame bucket, batches of 2."""
    from talkshow_torch.config import face_config
    from talkshow_torch.data.dataset import synthetic_face_dataset
    from talkshow_torch.train.trainer import Trainer
    cfg = face_config()
    cfg.train.epochs = 1
    cfg.log.print_every, cfg.log.save_every = 1, 1
    cfg.parallel.dp, cfg.parallel.tp = dp, tp
    ds = synthetic_face_dataset(num_clips=4, frames=int(30 * width["seconds"]),
                                bucketed=dp > 1)
    state, step = face_state(width, device, state_path)
    return Trainer(cfg, ds, lambda gen, dev: state, step, run_dir=run_dir, device=device,
                   needs_rng=True, batch_mode="face_clips",
                   face_bucket_frames=64 if dp > 1 else 0, face_batch_size=2 if dp > 1 else 1
                   ).setup()


def face_trainer_case(run_dir: str, width: dict, device, dp: int, tp: int,
                      state_path: str | None = None) -> dict:
    """The face trainer's epoch on a (dp, tp) mesh (its checkpoint written
    whole by rank 0), then the checkpoint resumed on the mesh: the history,
    and whether the resumed state equals the trained one bit for bit."""
    from talkshow_torch.parallel.collectives import unsharded
    tr = face_trainer(run_dir, width, device, dp, tp, state_path)
    tr.train()
    with unsharded(tr.state):
        trained = fingerprint(face_stats(tr.state))
    tr.resume(os.path.join(run_dir, "ckpt-0.pt"))
    with unsharded(tr.state):
        resumed = fingerprint(face_stats(tr.state))
    return {"history": tr.history, "steps": tr.global_step, "resumed_equal": trained == resumed}


def grouped_conv_case(device) -> dict:
    """wav2vec's positional conv shape (768 channels in 16 groups, 16
    taps here) split column-parallel over the first tp ranks, tp 2 (a
    rank's rows are whole groups) and tp 3 (256 rows a rank, groups of 48),
    against the whole conv on the same weights and input: the output, the
    input's gradient, the weight's (gathered) and the bias's, each as its
    largest difference over the whole conv's largest.  Every rank of the
    group joins each tp's sub-group; ranks at or past tp sit it out."""
    import torch.distributed as dist
    import torch.nn as nn
    from talkshow_torch.parallel.collectives import _shard_module, _split, whole
    from talkshow_torch.parallel.mesh import Mesh
    rank, out = dist.get_rank(), {}
    for tp in (2, 3):
        group = dist.new_group(list(range(tp)))
        if rank >= tp:
            continue
        gen = torch.Generator().manual_seed(tp)
        conv = nn.Conv1d(768, 768, 16, padding=8, groups=16)
        with torch.no_grad():
            for p in conv.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        x = torch.randn(2, 768, 20, generator=gen)
        up = torch.randn(2, 768, 21, generator=gen)
        conv, x, up = conv.to(device), x.to(device), up.to(device)
        split = copy.deepcopy(conv)
        grid = np.empty((1, tp), dtype=object)
        grid[0, :] = [torch.device(device)] * tp
        mesh = Mesh(grid, rank=rank, tp_group=group, distributed=True)
        _shard_module(split, mesh)
        with torch.no_grad():
            split.weight.data = _split(split.weight.data, mesh)
        xr, xt = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        y = conv(xr)
        (y * up).sum().backward()
        yt = split(xt)
        (yt * up).sum().backward()
        out[tp] = {"forward": _rel(yt.detach(), y.detach()), "input_grad": _rel(xt.grad, xr.grad),
                   "weight_grad": _rel(whole(split.weight.grad, mesh), conv.weight.grad),
                   "bias_grad": _rel(split.bias.grad, conv.bias.grad),
                   "rows": tuple(split.weight.shape)}
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python tests/torch_dist_check.py")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--layouts", nargs="*", default=[])
    p.add_argument("--width", choices=sorted(WIDTHS), default="toy")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--state", default=None, help="a converted JAX body-VQ state (torch.save)")
    p.add_argument("--jax_states", nargs="*", default=(),
                   help="JAX's body-VQ states after each step (torch.save of jax_stats)")
    p.add_argument("--fault", default=None, help="a layout to run for one step with a planted "
                   "fault: the last tp rank's parameter slices are never updated")
    p.add_argument("--device", default="cuda", help="cpu, or cuda (gloo: every rank on card 0; "
                   "nccl: rank r on card r)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--pixel", default=None, help="a layout to run the body-AE, LS3DCG and "
                   "body-pixel cases on (the trainer's run in <out>/pixel)")
    p.add_argument("--face", nargs="*", default=[],
                   help="layouts DxP for the face step: bucketed global batches where D > 1, "
                        "one whole clip a step otherwise")
    p.add_argument("--face_width", choices=sorted(FACE_WIDTHS), default="toy")
    p.add_argument("--face_steps", type=int, default=2)
    p.add_argument("--face_state", default=None, help="a converted JAX face state (torch.save)")
    p.add_argument("--face_data", default=None,
                   help="torch.save of {'whole': [...], 'bucketed': [...]}: the global face "
                        "batches of each kind, one a step, with their masks")
    p.add_argument("--face_fault", default=None, help="a layout to run the face step on for one "
                   "step with the planted fault")
    p.add_argument("--face_extra", default=None, help="a layout for one --bf16 face step; "
                   "then the grouped conv at tp 2 and 3")
    p.add_argument("--face_trainer", default=None, help="a layout for the face trainer's epoch "
                   "(<out>/face_run) and its resume")
    p.add_argument("--nccl_probe", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=90.0)
    args = p.parse_args(argv)
    if args.rank is None:            # the launcher
        os.makedirs(args.out, exist_ok=True)
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        launch(lambda r: rank_argv(r, args.world, port, argv if argv is not None
                                   else sys.argv[1:]), args.world, args.timeout, env)
        return 0
    return rank_main(args)


def rank_main(args) -> int:
    import torch.distributed as dist
    os.makedirs(args.out, exist_ok=True)
    from talkshow_torch.parallel.multihost import initialize_multihost
    if args.nccl_probe:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{args.port}",
                                world_size=1, rank=0)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        ok = bool(torch.equal(t.cpu(), torch.ones(4)))
        dist.destroy_process_group()
        torch.save({"nccl_all_reduce": ok}, os.path.join(args.out, "nccl.pt"))
        return 0 if ok else 1
    initialize_multihost(f"127.0.0.1:{args.port}", args.world, args.rank, args.backend,
                         timeout_s=args.timeout)
    device = torch.device("cpu" if args.device == "cpu" else
                          f"cuda:{args.rank if args.backend == 'nccl' else 0}")
    if device.type == "cuda":
        # f32 sums and deterministic cuDNN, as the train CLI sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    result, first_runs = {}, []
    for layout in args.layouts:
        dp, tp = (int(v) for v in layout.split("x"))
        result[layout] = body_vq_case(dp, tp, WIDTHS[args.width], device, args.steps, args.state,
                                      args.jax_states, first_runs=first_runs)
    if args.fault:
        dp, tp = (int(v) for v in args.fault.split("x"))
        result["fault"] = body_vq_case(dp, tp, WIDTHS[args.width], device, 1, args.state,
                                       fault=True, first_runs=first_runs)
    if args.pixel:
        dp, tp = (int(v) for v in args.pixel.split("x"))
        result["other"] = other_steps_case(dp, tp, device)
        result["pixel"] = pixel_case(os.path.join(args.out, "pixel"), device, dp, tp)
    fw = FACE_WIDTHS[args.face_width]
    data = (torch.load(args.face_data, weights_only=False) if args.face_data else {})
    for layout in args.face:
        dp, tp = (int(v) for v in layout.split("x"))
        result.setdefault("face", {})[layout] = face_case(
            dp, tp, fw, device, args.face_steps, args.face_state,
            data.get("bucketed" if dp > 1 else "whole"))
    if args.face_fault:
        dp, tp = (int(v) for v in args.face_fault.split("x"))
        result["face_fault"] = face_case(dp, tp, fw, device, 1, args.face_state,
                                         data.get("bucketed" if dp > 1 else "whole"), fault=True)
    if args.face_extra:
        dp, tp = (int(v) for v in args.face_extra.split("x"))
        result["face_bf16"] = face_case(dp, tp, fw, device, 1, args.face_state,
                                        dtype=torch.bfloat16)
        result["grouped_conv"] = grouped_conv_case(device)
    if args.face_trainer:
        dp, tp = (int(v) for v in args.face_trainer.split("x"))
        result["face_trainer"] = face_trainer_case(os.path.join(args.out, "face_run"), fw,
                                                   device, dp, tp, args.face_state)
    torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

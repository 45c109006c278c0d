"""Multi-process checks of the port's dp x tp training steps, and their
launcher (tests/test_torch_parallel_dist.py and chip_smoke.py's phase 34
run them).

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


def grads_of(state) -> dict:
    """{part: {name: gradient}} on the host (whole on a tp mesh)."""
    from talkshow_torch.parallel.collectives import whole
    mesh = getattr(state, "mesh", None)
    return {part: {k: (whole(p.grad, mesh) if getattr(p, "tp_sharded", False)
                       else p.grad).detach().cpu().clone() for k, p in m.named_parameters()}
            for part, m in state.models.items()}


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
    """max|a - b| over the scale (default max|b|; 1 for an all-zero b)."""
    scale = scale if scale is not None else b.abs().max().item()
    return (a.double().cpu() - b.double().cpu()).abs().max().item() / (scale or 1.0)


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
    out = {"bn": max(_rel(after["models"][part][k], v) for part, sd in want["models"].items()
                     for k, v in sd.items() if k.endswith(("running_mean", "running_var"))),
           "vq": max(_rel(after["vq"][part][k], v) for part, st in want["vq"].items()
                     for k, v in st.items() if torch.is_tensor(v) and v.is_floating_point())}
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
                         for k, v in ref_losses.items())}
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
    return {part: [k for k, _ in m.named_parameters()] for part, m in state.models.items()}


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
    - losses: relative;
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
FLOORS = dict(losses=1e-5, bn=1e-5, vq=1e-5, grads=1e-5, grads_l2=1e-5, update_off=1e-3,
              update_l2=1e-2)

#: a step that moved rows to other codes: at most this share of the rows
#: moved, its losses within 1e-3, and the L2 error of its parameters'
#: changes within 0.2.  One moved row of 5632 changes the gradients by
#: 5.7e-2 in L2, and so the Adam update of 15 % of the elements by more
#: than 1e-2 lr (L2 4.1e-2; full width on the card), where a slice left
#: un-updated reads 0.62 and a wrong step size 1.0 or more
MOVED = dict(rows=1e-2, losses=1e-3, update_l2=2e-1)


def step_failures(result: dict) -> list:
    """The steps of one layout's result that miss their bounds: every error
    within twice the row-order spread or its FLOORS entry; a step that
    moved rows to other codes within MOVED."""
    bad = []
    for s, errors in enumerate(result["errors"]):
        e, spread = errors["mesh"], errors["f32"]
        if e["moves"]:
            ok = (e["moves"] <= MOVED["rows"] * result["rows"] and e["losses"] <= MOVED["losses"]
                  and e["update_l2"] <= MOVED["update_l2"])
        else:
            ok = all(e[k] <= max(floor, 2 * spread[k]) for k, floor in FLOORS.items())
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
    torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

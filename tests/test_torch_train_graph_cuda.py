"""The body-pixel step replayed from a captured CUDA graph
(talkshow_torch/train/graph.py) against the same step run eagerly, on an
NVIDIA GPU, at the talkshow-3d prior's widths (256 x 15 over 2048 codes,
the 64 -> 256 audio encoder, the 1024-wide frozen VQ-VAEs), B = 16,
T = 88, f32 with TF32 off and cuDNN deterministic.  Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph_cuda.py

"Eager" is the step with `replayable` patched false, the path a mesh
takes.  Every comparison is bit for bit: a replay launches the eager
step's kernels in the eager order on the same addresses."""
from __future__ import annotations

import copy
from collections import Counter

import pytest
import torch

import chip_smoke
from talkshow_torch.tracing import counts
from talkshow_torch.train import steps as tsteps

ROWS, T, STEPS = 16, 88, 6
COUNTERS = ("train_graph_capture", "train_graph_replay", "grad_stats", "adam_apply")
GRAPH = ("train_graph_capture", "train_graph_replay")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


@pytest.fixture
def pair(cuda):
    """(step, state, twin, cfg): a fresh state and its copy with an
    optimizer of its own (`chip_smoke.pixel_pair`)."""
    return chip_smoke.pixel_pair(cuda, 0)


def _batches(cfg, dev, n: int, path: str = "given", seed: int = 1, rows=None) -> list:
    """n batches of ROWS rows (`rows[i]` for batch i where given): tokens and keep
    masks given, or the keep drawn by the step ("drawn_keep"), or poses in
    place of tokens ("poses")."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i in range(n):
        B = ROWS if rows is None else rows[i]
        b = {"aud_feat": torch.randn(B, T, cfg["audio_encoder"]["in_dim"], generator=g,
                                     device=dev),
             "speaker": torch.randint(0, cfg["prior"]["n_classes"], (B,), generator=g,
                                      device=dev),
             "tokens": torch.randint(0, cfg["vq"]["code_num"], (B, T // 4, 2), generator=g,
                                     device=dev),
             "aud_keep": torch.rand(B, T // 4, generator=g, device=dev) < 0.9}
        if path == "poses":
            b["poses"] = 0.1 * torch.randn(B, T, 165, generator=g, device=dev)
            del b["tokens"]
        if path == "drawn_keep":
            del b["aud_keep"]
        out.append(b)
    return out


def _run(step, state, batches, dev, drawn: bool, keys=GRAPH) -> tuple[list, dict]:
    """The steps' metrics and the counters of `keys` they moved."""
    before = Counter({k: counts[k] for k in COUNTERS})
    metrics = []
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=dev).manual_seed(100 + i) if drawn else None
        metrics.append(step(state, batch, gen)[1])
    return metrics, {k: counts[k] - before[k] for k in keys}


def _snapshot(state) -> dict:
    """Parameters, BatchNorm statistics, moments, Adam's step count and the
    skip count, copied."""
    out = {f"{k}.{n}": t.detach().clone() for k, m in state.models.items()
           for n, t in m.state_dict().items()}
    opt = state.optimizer
    for i, p in enumerate(opt.params):
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k}.{i}"] = opt.adam.state[p][k].clone()
    out["step_count"] = opt.step_count.clone()
    out["nonfinite"] = opt.nonfinite.clone()
    return out


def _assert_metrics_equal(got: list, want: list) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), (i, k, g[k], w[k])


def _assert_equal(a: dict, b: dict, skip=()) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if k not in skip:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["given", "drawn_keep", "poses"])
def test_replayed_steps_equal_eager_steps(cuda, pair, monkeypatch, path):
    """Six steps from one state: eager, and warm-up, capture, four replays;
    each step's metrics and the state after them bit-equal; one capture
    and four replays counted, none eagerly; the Adam kernels' counters
    once a step on both (a replay adds the launches its capture counted)."""
    step, replayed, eager, cfg = pair
    batches = _batches(cfg, cuda, STEPS, path)
    drawn = path == "drawn_keep"
    with monkeypatch.context() as m:
        m.setattr(tsteps, "replayable", lambda *args: False)
        want, moved = _run(step, eager, batches, cuda, drawn, COUNTERS)
    assert moved == {"train_graph_capture": 0, "train_graph_replay": 0, "grad_stats": STEPS,
                     "adam_apply": STEPS}
    got, moved = _run(step, replayed, batches, cuda, drawn, COUNTERS)
    assert moved == {"train_graph_capture": 1, "train_graph_replay": STEPS - 2,
                     "grad_stats": STEPS, "adam_apply": STEPS}
    assert replayed.graph.captured and replayed.step == eager.step == STEPS
    _assert_metrics_equal(got, want)
    _assert_equal(_snapshot(replayed), _snapshot(eager))


@pytest.mark.cuda
def test_a_new_shape_drops_the_graph(cuda, pair, monkeypatch):
    """A batch of another shape (8 rows after 16) drops the graph, warms
    up, captures at its second appearance and replays; so does the shape
    before it when it comes back.  Every step bit-equal to the eager step."""
    step, replayed, eager, cfg = pair
    rows = [16, 16, 16, 8, 8, 8, 16, 16, 16]
    batches = _batches(cfg, cuda, len(rows), rows=rows)
    with monkeypatch.context() as m:
        m.setattr(tsteps, "replayable", lambda *args: False)
        want, _ = _run(step, eager, batches, cuda, False)
    got, moved = [], []
    for b in batches:
        metrics, counted = _run(step, replayed, [b], cuda, False)
        got += metrics
        moved.append((counted["train_graph_capture"], counted["train_graph_replay"]))
    # warm-up (0, 0), capture (1, 0), replay (0, 1)
    assert moved == [(0, 0), (1, 0), (0, 1)] * 3, moved
    assert replayed.graph.captured
    _assert_metrics_equal(got, want)
    _assert_equal(_snapshot(replayed), _snapshot(eager))


@pytest.mark.cuda
def test_nonfinite_batch_in_a_replay_is_skipped(cuda, pair):
    """A NaN in one replayed step's audio features: the skip count goes up
    by one, parameters, moments, Adam's count and BatchNorm statistics stay;
    the next replay steps again."""
    step, state, _, cfg = pair
    batches = _batches(cfg, cuda, 4)
    for b in batches[:3]:
        step(state, b)
    before = _snapshot(state)
    bad = dict(batches[3], aud_feat=batches[3]["aud_feat"].clone())
    bad["aud_feat"][0, 0, 0] = float("nan")
    _, moved = _run(step, state, [bad], cuda, False)
    assert moved == {"train_graph_capture": 0, "train_graph_replay": 1}
    after = _snapshot(state)
    assert int(after["nonfinite"]) == int(before["nonfinite"]) + 1 == 1
    _assert_equal(after, before, skip=("nonfinite",))
    _, metrics = step(state, batches[3])
    assert int(metrics["nonfinite_skips"]) == 1 and torch.isfinite(metrics["ce_loss"])
    assert not torch.equal(_snapshot(state)["prior.out_logits.weight"],
                           before["prior.out_logits.weight"])


@pytest.mark.cuda
def test_load_state_dict_captures_again(cuda, pair):
    """A load drops the graph: the next step warms up, the one after
    captures, and from the loaded state they give what the first pass gave."""
    step, state, _, cfg = pair
    batches = _batches(cfg, cuda, 3)
    step(state, batches[0])
    saved = copy.deepcopy(state.state_dict())
    for b in batches[1:]:
        step(state, b)
    want = _snapshot(state)
    state.load_state_dict(saved)
    assert not state.graph.captured
    _, moved = _run(step, state, batches[1:], cuda, False)
    assert moved == {"train_graph_capture": 1, "train_graph_replay": 0}
    _assert_equal(_snapshot(state), want)


@pytest.mark.cuda
def test_eager_and_replayed_steps_do_not_sync(cuda, pair, monkeypatch):
    """No operation of the eager step or of a replay waits for the card
    (`torch.cuda.set_sync_debug_mode("error")` raises on one)."""
    step, state, eager, cfg = pair
    batches = _batches(cfg, cuda, 3)

    def strict(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with monkeypatch.context() as m:
        m.setattr(tsteps, "replayable", lambda *args: False)
        step(eager, batches[0])              # loads the kernels, makes the moments
        strict(lambda: step(eager, batches[1]))
    step(state, batches[0])
    step(state, batches[1])
    strict(lambda: step(state, batches[2]))


@pytest.mark.cuda
def test_a_hooked_step_runs_eagerly(cuda, pair, monkeypatch):
    """A hook on a parameter, registered after the capture, runs: that step
    is eager, nothing replayed; once the hook is gone the graph replays, and
    the parameters' gradients are the replay's.  Four steps bit-equal to
    the eager steps."""
    step, state, eager, cfg = pair
    batches = _batches(cfg, cuda, 4)
    with monkeypatch.context() as m:
        m.setattr(tsteps, "replayable", lambda *args: False)
        want, _ = _run(step, eager, batches, cuda, False)
    got, _ = _run(step, state, batches[:2], cuda, False)
    calls = []
    leaf = next(state.models["prior"].parameters())
    hook = leaf.register_hook(lambda g: calls.append(g.shape))
    metrics, moved = _run(step, state, batches[2:3], cuda, False)
    hook.remove()
    assert calls == [leaf.shape] and moved == {"train_graph_capture": 0, "train_graph_replay": 0}
    eager_grad = leaf.grad
    got += metrics
    metrics, moved = _run(step, state, batches[3:], cuda, False)
    assert moved == {"train_graph_capture": 0, "train_graph_replay": 1}
    assert leaf.grad is not eager_grad and torch.equal(leaf.grad, eager.optimizer.params[0].grad)
    _assert_metrics_equal(got + metrics, want)
    _assert_equal(_snapshot(state), _snapshot(eager))

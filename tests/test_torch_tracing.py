"""talkshow_torch/tracing.py: spans off and on, one `generate` as one tree
of spans under its root, the counts charged to that root, the span names
in the profiler's Chrome trace and in the benchmark's reduction of it, and
the benchmark's readers of the program's spans on toy traced cells (CPU).

On the card (marker `cuda`; this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m cuda

holds `host_sync` to the synchronising calls that
`torch.cuda.set_sync_debug_mode("warn")` reports in one `generate`, one
`get_mfcc` + `generate_body`, one body-VQ step and one body-pixel step at
the benchmark's widths: every read from the card and copy to it on those
paths goes through `tracing.to_host` / `to_device`."""
from __future__ import annotations

import json
import warnings
import wave

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import toy
from benchmark.trace import reduce_events
from talkshow_torch import kernels, tracing
from talkshow_torch import utils as U
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.pipeline import Pipeline

TINY = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
BODY = dict(num_hiddens=64, pixel_dim=16, pixel_layers=3, code_num=64)
#: the spans under one `generate` of a 22.05 kHz clip (resampled for the
#: face stage and for the MFCC) on the CPU, where no copy to a device waits
TREE = {"generate", "generate/wav_read", "generate/resample", "generate/face_stage",
        "generate/face_stage/device_wait", "generate/mfcc", "generate/mfcc/wav_read",
        "generate/mfcc/resample", "generate/device_wait", "generate/body_stage",
        "generate/body_stage/ar_decode", "generate/body_stage/device_wait",
        "generate/assembly"}
#: the new metrics of each toy cell, and its host syncs a request or step on
#: the CPU: the face, MFCC and body readbacks; the body readback; none in
#: the Adam steps, whose skip decision stays on the device (the conv-channel
#: index is copied to the card only on the card)
NEW = {"toy-gen": (("host_syncs.lat", "host_ms.lat", "audio_io_ms.lat"), 3.0),
       "toy-body": (("host_syncs.batch", "host_ms.batch"), 1.0),
       "toy-pixel": (("host_syncs.train", "host_ms.train", "optimizer_ms.train"), 0.0),
       "toy-vq": (("host_syncs.train", "host_ms.train", "optimizer_ms.train"), 0.0)}
SYNCS = {"toy-gen": "host_syncs.lat", "toy-body": "host_syncs.batch",
         "toy-pixel": "host_syncs.train", "toy-vq": "host_syncs.train"}

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def pipe():
    return Pipeline.create(0, "cpu", wav2vec_cfg=Wav2Vec2Config(**TINY), **BODY)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("wav") / "clip.wav"
    x = (np.sin(np.arange(22050) / 20.0) * 8000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(x.tobytes())
    return str(path)


def test_counts_is_the_kernels_counter():
    assert kernels.counts is tracing.counts


def test_span_off_records_nothing(pipe, wav):
    assert not tracing.recording()
    with tracing.span("outer", a=1) as sp:
        sp.set(b=2)
        with tracing.span("inner"):
            pass
    assert tracing.span("x") is tracing.span("y")            # the shared no-op
    before = tracing.counts["host_sync"]
    pipe.generate(wav, 0, 1, seed=1)
    snap = tracing.snapshot()
    assert snap["spans"] == {} and snap["roots"] == {} and snap["recent"] == []
    assert tracing.counts["host_sync"] == before + 3         # counters always count


def _generate(pipe, wav, mode):
    if mode == "enable":
        tracing.enable()
        pipe.generate(wav, 0, 2, seed=1)
        tracing.disable()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pipe.generate(wav, 0, 2, seed=1)


@pytest.mark.parametrize("mode", ["enable", "profiler"])
def test_generate_is_one_tree(pipe, wav, mode):
    kernels.counts.clear()
    _generate(pipe, wav, mode)
    snap = tracing.snapshot()
    assert set(snap["spans"]) == TREE
    assert snap["roots"] == {"generate": {"count": 1, "counts": {
        "host_sync": 3, "face_plain": 1, "sample_tokens_plain": 1}}}
    assert snap["counts"] == {"host_sync": 3, "face_plain": 1, "sample_tokens_plain": 1}
    (root,) = snap["recent"]
    assert root["name"] == "generate" and root["parent"] is None
    assert root["attrs"] == {"samples": 2, "wav_len": 22050}
    ids = {root["id"]} | {s["id"] for s in root["spans"]}
    assert len(root["spans"]) == len(TREE) - 1 == len(ids) - 1
    for s in root["spans"]:
        assert s["root"] == root["id"] and s["parent"] in ids
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
    by_name = {s["name"]: s for s in root["spans"]}
    assert [s["attrs"] for s in root["spans"] if s["name"] == "resample"] == [
        {"orig": 22050, "new": 16000}, {"orig": 22050, "new": 22000}]
    assert by_name["ar_decode"]["attrs"] == {"B": 2, "H": 7, "noise_given": False}
    assert by_name["body_stage"]["attrs"] == {"samples": 2, "frames": 30}
    # the self times of a tree add up to its root's time
    spans = snap["spans"]
    assert sum(a["self_ns"] for a in spans.values()) == spans["generate"]["total_ns"]
    assert all(0 <= a["self_ns"] <= a["total_ns"] for a in spans.values())
    tracing.reset()
    assert tracing.snapshot()["spans"] == {}


def test_chrome_trace_carries_spans_and_reduction_files_gaps(pipe, wav, tmp_path):
    with U.trace(str(tmp_path)):
        pipe.generate(wav, 0, 1, seed=1)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"span:generate", "span:wav_read", "span:resample", "span:mfcc",
            "span:device_wait", "span:face_stage", "span:body_stage", "span:ar_decode",
            "span:assembly"} <= names
    # a device gap in the middle of the MFCC's resample is filed under it
    (rs,) = [e for e in events if e.get("name") == "span:resample" and e.get("ph") == "X"
             and any(p.get("name") == "span:mfcc" and p["ts"] <= e["ts"] <= p["ts"] + p["dur"]
                     for p in events if p.get("ph") == "X")]
    t0, dur = rs["ts"], rs["dur"]
    kernels_ = [{"ph": "X", "cat": "kernel", "name": "k", "ts": t0 - 5.0, "dur": 5.0 + dur / 4},
                {"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + 3 * dur / 4, "dur": 5.0}]
    out = reduce_events(events + kernels_)
    (label,) = out["idle_by_host"]
    assert label.startswith("span:resample"), label
    assert out["idle_by_host"][label] == pytest.approx(dur / 2 * 1e-6)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toybench")
    toy.make_tree(root)
    return root


@pytest.mark.parametrize("cell", sorted(NEW))
def test_toy_traced_cell_reads_the_new_metrics(toy_root, cell):
    spec = toy.spec(toy_root, cell)
    out, run = harness.execute(spec, 2 ** 40 + 17, 1.5, True, "cpu", with_run=True)
    assert out["correct"], out["checks"]
    names, syncs = NEW[cell]
    got = {n: harness.metric_reader(n, spec["here"])(run) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got[SYNCS[cell]] == syncs
    entry = {"toy-gen": "generate", "toy-body": "body_stage"}.get(cell, "train_step")
    assert tracing.snapshot()["roots"][entry]["count"] > 0
    # untraced, the program records nothing and the readers read nothing
    tracing.reset()
    out = harness.execute(spec, 2 ** 40 + 18, 0.5, False, "cpu")
    assert out["correct"] and all(
        harness.metric_reader(n, spec["here"])(None) is None for n in names)


def _sync_calls(fn):
    """(synchronising calls that sync-debug mode reports in fn(), host_sync
    counts fn() adds)."""
    before = tracing.counts["host_sync"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("called a synchronizing CUDA operation" in str(w.message) for w in got)
    return n, tracing.counts["host_sync"] - before


@pytest.mark.cuda
def test_host_sync_counts_every_sync_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from benchmark import gen, traffic, weights
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    from talkshow_torch.ops import audio as audio_ops
    from talkshow_torch.train.steps import make_body_pixel_step, make_body_vq_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    cfg = harness.cell_spec(bench, "gen-3d-s1")["cfg"]
    pipe = gen.build_program(cfg, weights.draw(cfg, 5, "cuda"), "cuda")
    wl = {"clip_seconds": [4], "variants": 1, "speakers": [0]}
    (clip,) = traffic.make_clips(wl, 5, str(tmp_path))
    got = {}
    for name, fn in (
            ("generate", lambda: pipe.generate(clip.path, 0, num_samples=1, seed=3)),
            ("get_mfcc", lambda: audio_ops.get_mfcc(clip.path, device="cuda")),
            ("generate_body", lambda: pipe.generate_body(feat, 0, num_samples=12, seed=3))):
        if name == "generate_body":
            feat = audio_ops.get_mfcc(clip.path, device="cuda").cpu().numpy()
        fn()                                    # packs the tables, loads the kernels
        got[name] = _sync_calls(fn)

    gen_ = torch.Generator().manual_seed(0)
    vq, pr, ae = cfg["vq"], cfg["prior"], cfg["audio_encoder"]

    def vqvae(part):
        return VQVAE(vq[f"{part}_channels"], vq["embedding_dim"], vq["num_hiddens"],
                     vq["num_residual_layers"])

    B, T = 8, 88
    init, vq_step = make_body_vq_step(vqvae("body"), vqvae("hand"), code_num=vq["code_num"])
    state = init(gen_, "cuda")
    poses = 0.1 * torch.randn(B, T, 165, device="cuda")
    vq_step(state, {"poses": poses})
    got["body_vq_step"] = _sync_calls(lambda: vq_step(state, {"poses": poses}))

    frozen = {k: v for k, v in state.vq.items()}
    prior = GatedPixelCNN(input_dim=pr["input_dim"], dim=pr["dim"], n_layers=pr["n_layers"],
                          n_classes=pr["n_classes"], audio_channels=ae["num_hiddens"],
                          hidden=pr["hidden"])
    audio = AudioEncoder(ae["in_dim"], num_hiddens=ae["num_hiddens"])
    init, px_step = make_body_pixel_step(prior, audio, state.models["body"],
                                         state.models["hand"], frozen)
    pstate = init(gen_, "cuda")
    batch = {"aud_feat": torch.randn(B, T, ae["in_dim"], device="cuda"),
             "speaker": torch.randint(0, pr["n_classes"], (B,), device="cuda"),
             "tokens": torch.randint(0, vq["code_num"], (B, T // 4, 2), device="cuda"),
             "aud_keep": torch.rand(B, T // 4, device="cuda") < 0.9}
    px_step(pstate, batch)
    got["body_pixel_step"] = _sync_calls(lambda: px_step(pstate, batch))
    print("sync calls (sync-debug, host_sync):", got)
    assert all(n == counted > 0 for n, counted in got.values()), got

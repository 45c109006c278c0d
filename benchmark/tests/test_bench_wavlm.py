"""The WavLM face cell at toy widths on the CPU: its driver, reference,
weights and counts load through the harness from files of their own, the
program's plain path agrees with `reference/wavlm.py`, and the planted
faults (the gate held at 1, the bias dropped, a shifted face) fail the
check."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness, wavlm_counts, wavlm_faults, wavlm_weights
from benchmark.reference import wavlm as ref_wavlm
from benchmark.tests import toy

#: WavLM's structure at toy widths: 2 pre-norm layers of 64 in 4 heads, the
#: published 320 buckets and distance 800, a LayerNorm conv extractor
W = {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "intermediate_size": 128,
     "conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
     "conv_stride": [5, 2, 2, 2, 2, 2, 2], "num_conv_pos_embeddings": 16,
     "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5, "do_stable_layer_norm": True,
     "feat_extract_norm": "layer", "conv_bias": False, "num_buckets": 320,
     "max_bucket_distance": 800}
CFG = {**toy.TOY_CFG, "wav2vec": W,
       "precision": {"decode_tables": "bfloat16", "face_tables": "bfloat16"}}
#: CPU: the program's plain float32 path against the float32 reference; the
#: two differ in summation order only (~1e-6 relative)
LIMIT = 1e-4


@pytest.fixture(scope="module")
def face_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavlmbench")
    here = toy.make_tree(root, extra_metric=False)
    shutil.copy(harness.HERE / "drivers" / "generate_face.py", here / "drivers")
    json.dump(CFG, open(here / "configs" / "wavlm.json", "w"))
    json.dump({"driver": "generate_face", "clip_seconds": [1, 3], "variants": 1,
               "speakers": [0], "noise_given_per_block": 0, "check_per_length": 1,
               "limits": {"face_rel": LIMIT}}, open(here / "workloads" / "toy-face.json", "w"))
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "wavlm", "source": "test",
                             "file": "benchmark/configs/wavlm.json", "reduced": [],
                             "why": "toy widths"})
    bench["workloads"].append({"name": "toy-face", "config": "wavlm", "traffic": "toy-face",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "toy-gen" in m["workloads"]:
            m["workloads"].append("toy-face")
    for name in ("mfu.face", "device_idle_pct.lat", "face_stage_ms.lat",
                 "encoder_roofline_pct.face", "extractor_roofline_pct.face"):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                   "source": "host_clock", "layer": "test",
                                   "moves": "clip_ms_p95", "workloads": ["toy-face"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return root


def _run(root, **kw):
    return harness.execute(toy.spec(root, "toy-face"), 2 ** 40 + 11, 1.0, False, "cpu", **kw)


def test_face_cell_runs_and_agrees(face_root):
    out = _run(face_root, hooks={"control": True})
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["face_rel"]["value"] < LIMIT
    assert set(out["metrics"]) == {"clip_ms_p95", "motion_s_per_s", "setup_s"}


def test_face_cell_traced_reads_mfu(face_root):
    out = harness.execute(toy.spec(face_root, "toy-face"), 5, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    # the CPU path launches no kernel: the rooflines have nothing to read
    assert out["metrics"]["mfu.face"]["value"] > 0
    assert "encoder_roofline_pct.face" not in out["metrics"]


@pytest.mark.parametrize("fault", ["gate_one", "bias_drop"])
def test_planted_faults_fail(face_root, fault):
    undo = wavlm_faults.plant(fault)
    try:
        out = _run(face_root)
    finally:
        undo()
    assert not out["correct"], out["checks"]


def test_control_reads_above_the_program(face_root):
    _, run = _run(face_root, hooks={"control": True}, with_run=True)
    assert run.extra["control"]["face_rel"] > 100 * LIMIT


def test_weights_follow_the_rules():
    w = wavlm_weights.draw(CFG, 3, "cpu")["face"]
    assert torch.equal(w["audio_encoder.encoder.layers.1.attention.q_proj.weight"],
                       wavlm_weights.draw(CFG, 3, "cpu")["face"][
                           "audio_encoder.encoder.layers.1.attention.q_proj.weight"])
    const = w["audio_encoder.encoder.layers.0.attention.gru_rel_pos_const"]
    assert const.shape == (1, 4, 1, 1) and (const - 1).abs().max() <= 0.1
    table = w["audio_encoder.encoder.layers.0.attention.rel_attn_embed.weight"]
    assert table.shape == (320, 4) and 0.5 < float(table.std()) < 1.5
    assert "audio_encoder.encoder.layers.1.attention.rel_attn_embed.weight" not in w
    ref_wavlm.Reference(CFG, {"face": w}, "cpu")      # loads strictly


def test_counts():
    full = json.load(open(harness.ROOT / "benchmark/configs/talkshow-wavlm-large.json"))
    flops, nbytes = wavlm_counts.encoder_work(full, 900)
    # 24 layers: products 2 T (4 H^2 + 2 H F) + attention 4 T^2 H: ~623 GFLOP at 30 s,
    # of the whole face's ~785 (the extractor ~147, the positional conv ~15)
    assert 6.1e11 < flops < 6.4e11
    assert 7.7e11 < wavlm_counts.face_flops(full, 16000 * 30) < 8.1e11
    assert 6.0e8 < nbytes < 6.6e8                      # ~604 MB of bf16 matrices
    fl5, nb5 = wavlm_counts.encoder_work(full, 150)
    assert nb5 / 3.35e12 > fl5 / 989e12                # 5 s: bound by bytes
    assert flops / 989e12 > nbytes / 3.35e12           # 30 s: bound by operations
    ext = wavlm_counts.extractor_work(full, 16000 * 10)
    assert 4.5e10 < ext[0] < 5.5e10
    assert wavlm_counts.face_flops(CFG, 16000) > 0


@pytest.fixture(scope="module")
def serve_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("servebench")
    here = toy.make_tree(root, extra_metric=False)
    wl = json.load(open(harness.HERE / "workloads" / "serve-3d-open.json"))
    wl.update(rate_per_s=6.0, clip_seconds_range=[1, 2], sources=2, bucket_frames=16,
              max_batch=2, noise_given_every=2, keep_given_share=1.0, check_noise_given=2,
              check_others=1, limits=dict(toy.TOY_LIMITS))
    json.dump(wl, open(here / "workloads" / "toy-serve.json", "w"))
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["workloads"].append({"name": "toy-serve", "config": "toy", "traffic": "toy-serve",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "toy-gen" in m["workloads"]:
            m["workloads"].append("toy-serve")
    for name in ("mfu.lat", "device_idle_pct.lat"):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                   "source": "host_clock", "layer": "test",
                                   "moves": "clip_ms_p95", "workloads": ["toy-serve"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return root


def test_serve_cell_runs_and_agrees(serve_root):
    from benchmark.drivers import serve
    wl = json.load(open(serve_root / "benchmark" / "workloads" / "toy-serve.json"))
    due = serve.arrivals(wl, 7, 30.0)
    assert due == serve.arrivals(wl, 7, 30.0) and 0.5 * 180 < len(due) < 1.5 * 180
    cut = serve.clips(wl, 7, 500, 2 * 16000)
    sec = np.array([m for _, _, m in cut]) / 16000
    assert sec.min() >= 1.0 and sec.max() <= 2.0 and len(set(sec)) > 400   # one length a request
    assert all(0 <= o and o + m <= 2 * 16000 and 0 <= s < 2 for s, o, m in cut)
    out = harness.execute(toy.spec(serve_root, "toy-serve"), 2 ** 40 + 3, 2.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["token_gap"]["value"] < 1e-3
    assert "mfu.lat" in out["metrics"]

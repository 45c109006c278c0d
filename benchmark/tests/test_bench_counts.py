"""The yardstick's arithmetic against counts worked by hand at toy widths."""
from __future__ import annotations

import pytest
import torch

from benchmark import counts, readers
from benchmark.reference import audio as ref_audio
from benchmark.trace import reduce_events

#: L = 2 layers, d = 4, K = 8 codes, head 6, audio 3 channels
TOY = dict(L=2, d=4, K=8, hid=6, A=3)


def test_ar_decode_macs_by_hand():
    # vertical: 2 columns x (layer 0: 2 real input columns x 3 rows x d x 2d = 192,
    #            layer 1: 2 x 2 rows x d x 2d = 128)                          = 640
    # vert_to_horiz: 2 columns x 2 layers x 2d x 2d                            = 256
    # horizontal: layer 0 column 1 reads column 0 (d x 2d = 32), column 0 nothing;
    #             layer 1 column 0 its own tap (32), column 1 both (64)         = 128
    # horiz_resid 2 x 2 x d x d = 64; fusions: 2 x 2 x d x d token halves + 2 x d x d
    # audio halves = 96; audio embedding 3 x 4 = 12; head 2 x (4 x 6 + 6 x 8) = 144
    assert counts.ar_decode_macs_per_row(**TOY) == 640 + 256 + 128 + 64 + 96 + 12 + 144


def test_ar_decode_bytes_by_hand():
    # weights: vert 2d.d.3.3 = 288 + 2d.d.2.3 = 192; v2h 2 x 64 = 128; horiz 32 + 64;
    # resid 2 x 16 = 32; fusions 2 x 32 = 64; audio 12; head 24 + 48  -> 884
    # embedding rows: min(K, 2 B H) = 8 rows x d = 32           -> (884 + 32) x 2 bytes
    # biases 2 x 7d + 3d + 6 + 8 = 82; inputs B H A = 30 + L B 2d = 32 -> 144 x 4 bytes
    # tokens 2 x 5 x 2 x 4 bytes
    n = counts.ar_decode_bytes(H=5, B=2, table_dtype="bfloat16", noise_given=False, **TOY)
    assert n == 2 * (884 + 32) + 4 * (82 + 62) + 80
    given = counts.ar_decode_bytes(H=5, B=2, table_dtype="bfloat16", noise_given=True, **TOY)
    assert given - n == 4 * 5 * 2 * 2 * 8


def test_least_s_takes_the_longer_bound():
    assert counts.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.least_s(0.0, 989e12) == pytest.approx(1.0)
    assert counts.least_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_mfcc_frames_match_the_reference_front_end():
    for n in (16000, 16000 * 2 + 123, 16000 * 4):
        feat = ref_audio.get_mfcc(torch.zeros(n).uniform_(-0.1, 0.1))
        assert feat.shape == (counts.mfcc_frames(n), 64)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_union_counts_overlaps_once():
    events = [_ev("kernel", "a", 0, 10), _ev("kernel", "b", 5, 10),     # union 0..15
              _ev("gpu_memcpy", "copy", 20, 5),                         # 20..25
              _ev("kernel", "a", 40, 10),                               # 40..50
              _ev("user_annotation", "span:body", 0, 60),
              _ev("cpu_op", "aten::conv1d", 26, 10)]
    r = reduce_events(events)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["kernels"]["a"] == pytest.approx(20e-6)
    assert r["launches"] == 3
    assert r["idle_by_host"] == pytest.approx({"span:body": 5e-6,
                                               "span:body/aten::conv1d": 15e-6})


def test_idle_and_roofline_readers_by_hand():
    run = type("R", (), {})()
    run.profile = {"window_s": 0.1, "busy_s": 0.09, "kernels": {"ns::decode_kernel<bf16>": 0.02}}
    run.cfg = {"prior": {"n_layers": 2, "dim": 4, "input_dim": 8, "hidden": 6},
               "audio_encoder": {"num_hiddens": 3}, "precision": {"decode_tables": "bfloat16"}}
    run.requests = [{"profiled": True, "notes": [{"span": "ar_decode", "B": 2, "H": 5,
                                                  "noise_given": False}]}]
    assert readers.device_idle_pct(run) == pytest.approx(10.0)
    least = counts.ar_decode_least_s(run.cfg["prior"], 3, 5, 2, "bfloat16", False)
    assert least == pytest.approx(2488 / 3.35e12)
    assert readers.ar_decode_roofline_pct(run) == pytest.approx(100 * least / 0.02)
    run.profile["kernels"] = {}
    assert readers.ar_decode_roofline_pct(run) is None

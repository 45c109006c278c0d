"""The port's full-schedule orchestrators (talkshow_torch/full_schedule.py,
talkshow_torch/eval_full_schedule.py) and its synthetic SHOW writer
(talkshow_torch/data/synthetic_show.py) against the JAX package's scripts
on the CPU: `derived_config`, `summarize_history` and `CURVE_KEYS` equal to
scripts/train_full_schedule.py's and scripts/eval_full_schedule.py's on
the same inputs; the synthetic tree byte-equal to
scripts/make_synthetic_show.py's at a small size; and one toy schedule end
to end (all five trainables at narrow widths, then the eval battery),
whose EVAL json carries every key the JAX script writes."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from talkshow_torch import config as tconfig
from talkshow_torch import eval_full_schedule as efs
from talkshow_torch import full_schedule as fs
from talkshow_torch.data import synthetic_show as ss
from talkshow_torch.models import face as tface
from talkshow_torch.models import pixelcnn as tp
from talkshow_torch.models import vqvae as tv
from talkshow_torch.models import wav2vec as tw2v
from talkshow_torch.train import __main__ as cli

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import eval_full_schedule as jefs  # noqa: E402
import train_full_schedule as jfs  # noqa: E402

torch.set_num_threads(2)


def test_derived_config_and_curve_keys_match_jax(tmp_path):
    src = tmp_path / "src.json"
    json.dump(tconfig.body_vq_config().to_reference_dict(), open(src, "w"))
    a = fs.derived_config(str(src), str(tmp_path / "a.json"), model_name="s2g_body_ae")
    b = jfs.derived_config(str(src), str(tmp_path / "b.json"), model_name="s2g_body_ae")
    assert open(a).read() == open(b).read()
    assert json.load(open(a))["Model"]["model_name"] == "s2g_body_ae"
    assert fs.CURVE_KEYS == jfs.CURVE_KEYS


def test_stage_configs_from_defaults_round_trip(tmp_path):
    paths = fs.stage_configs(None, str(tmp_path))
    for stage, path in paths.items():
        want = fs._DEFAULTS[stage]()
        assert tconfig.Config.from_reference_json(path).to_json() == want.to_json(), stage
    assert fs.stage_configs("/cfg", str(tmp_path))["ls3dcg"] == "/cfg/LS3DCG.json"


@pytest.mark.parametrize("n", [8, 3])
def test_summarize_history_matches_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    for stage, key in fs.CURVE_KEYS.items():
        d = tmp_path / stage
        d.mkdir()
        hist = [{"epoch": i, key: float(rng.random() / (i + 1)),
                 "epoch_seconds": float(rng.random()), "nonfinite_skips": float(i % 2)}
                for i in range(n)]
        json.dump(hist, open(d / "history.json", "w"))
    (tmp_path / "face" / "history.json").write_text("[]")     # partially written: skipped
    assert efs.summarize_history(str(tmp_path)) == jefs.summarize_history(str(tmp_path))
    assert set(efs.summarize_history(str(tmp_path))) == set(fs.CURVE_KEYS) - {"face"}


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_synthetic_tree_is_byte_equal_to_the_script(tmp_path):
    args = ["--clips-per-speaker", "2", "--train-seconds", "3", "--eval-seconds", "2",
            "--seed", "3"]
    script = os.path.join(REPO, "scripts", "make_synthetic_show.py")
    for extra in ([], ["--only-extra-test", "2"]):
        subprocess.run([sys.executable, script, "--root", str(tmp_path / "jax")] + args + extra,
                       check=True, capture_output=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
        ss.main(["--root", str(tmp_path / "port")] + args + extra)
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert len(want) == 2 * 4 * (2 + 2 + 2) and got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)


# ---------------------------------------------------------------------------
# one toy schedule, end to end
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _narrow(monkeypatch):
    """Every model the train CLI and the eval battery build, at toy widths."""
    vq = lambda width, emb, nh: tv.VQVAE(width, emb, 16)               # noqa: E731
    prior = lambda **kw: tp.GatedPixelCNN(                              # noqa: E731
        input_dim=kw["input_dim"], dim=16, n_layers=2, n_classes=kw["n_classes"],
        audio_channels=32, bh_model=kw["bh_model"], dtype=kw.get("dtype"))
    audio = lambda num_hiddens: tv.AudioEncoder(num_hiddens=32)        # noqa: E731
    face = lambda cfg=None: tface.FaceGenerator(tw2v.Wav2Vec2Config(  # noqa: E731
        **TINY, dtype=cfg.dtype if cfg else None))
    ae = lambda in_dim, num_hiddens: tv.AE(in_dim, num_hiddens=16)     # noqa: E731
    for mod in (cli, efs):
        for name, fn in (("VQVAE", vq), ("GatedPixelCNN", prior), ("AudioEncoder", audio),
                         ("FaceGenerator", face), ("AE", ae)):
            monkeypatch.setattr(mod, name, fn)


def _toy_configs(config_dir):
    """Reference configs at batch 4, 16-frame windows, 64 codes."""
    os.makedirs(config_dir)
    for stage, fname in fs.CONFIG_FILES.items():
        raw = fs._DEFAULTS[stage]().to_reference_dict()
        raw["Data"]["pose"]["generate_length"] = 16
        raw["DataLoader"]["batch_size"] = 4 if stage != "face" else 1
        raw["Model"]["code_num"] = 64
        raw["Log"]["print_every"] = 2
        json.dump(raw, open(os.path.join(config_dir, fname), "w"))


def test_toy_schedule_end_to_end(tmp_path, monkeypatch):
    _narrow(monkeypatch)
    data, run_root, cfgs = tmp_path / "data", tmp_path / "run", tmp_path / "cfg"
    ss.write_show_tree(str(data), clips_per_speaker=1, train_seconds=3.0, eval_seconds=2.0)
    _toy_configs(str(cfgs))
    out = fs.main(["--data_root", str(data), "--run_root", str(run_root), "--smoke",
                   "--stages", "body_vq", "body_pixel", "face", "body_ae", "ls3dcg", "eval",
                   "--smplx_npz", str(tmp_path / "rig.npz"), "--config_dir", str(cfgs),
                   "--device", "cpu", "--tag", "toy"])
    status = json.load(open(run_root / "status.json"))
    stages = ("body_vq", "body_pixel", "face", "body_ae", "ls3dcg", "eval")
    assert all(status["stages"][s]["state"] == "done" for s in stages)
    assert "finished" in status and out["status"]["finished"] == status["finished"]
    # the CPU runs the kernels' plain versions: no kernel launch is counted
    assert all(v == 0 for s in stages for v in status["stages"][s]["launches"].values())
    for stage in stages[:-1]:
        assert os.path.isfile(run_root / "docs" / "toy_schedule" / f"{stage}.history.json")
        assert os.path.isfile(run_root / stage / "ckpt-1.pt")
        assert "$ python -m talkshow_torch.train" in open(run_root / f"{stage}.log").read()
    res = json.load(open(run_root / "EVAL_toy.json"))
    assert res == out["eval"]
    src = open(os.path.join(REPO, "scripts", "eval_full_schedule.py")).read()
    jax_keys = set(re.findall(r'results\["(\w+)"\]', src)) - {"rep6d"}
    assert jax_keys <= set(res), jax_keys - set(res)
    assert set(res["train_summary"]) == set(stages[:-1]) and res["smplx"]
    assert res["num_test_clips"] == 4 and res["num_samples"] == 4

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []

    assert all(np.isfinite(v) for v in numbers(res))
    assert all("draws" not in v.get("fgd_ci", {}) for v in res.values() if isinstance(v, dict))

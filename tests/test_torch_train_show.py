"""Training on the SHOW layout: `talkshow_torch/data/preprocess.py` against
talkshow_tpu/data/preprocess.py on one synthetic clip tree (the same clips
kept, the same split for the same seed, exactly), and the train CLI without
`--synthetic`: `--data_root` / `--speakers`, the train split read through
`ShowDataset.from_root` with its cache at <data_root>/train<pklname>, the
MFCC for the window stages and the raw waveform of whole clips for the
faceformer face stage (toy widths, as tests/test_torch_train_pixel.py and
tests/test_torch_train_face.py build them)."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from talkshow_tpu.data import preprocess as jpre
from talkshow_torch.data import dataset as tdata
from talkshow_torch.data import preprocess as tpre
from talkshow_torch.kernels import counts
from talkshow_torch.models import face as tface
from talkshow_torch.models import vqvae as tv
from talkshow_torch.models import wav2vec as tw2v
from talkshow_torch.train import __main__ as cli
from test_torch_harness import TINY, write_wav

torch.set_num_threads(2)
W, B = 16, 2


def _write_clip(root, speaker, vid, split, name, frames, seed, nan=False, bad_wav=False,
                drop_key=None):
    d = os.path.join(root, speaker, vid, split, name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    data = {"jaw_pose": 0.1 * rng.standard_normal((frames, 3)),
            "leye_pose": 0.1 * rng.standard_normal((frames, 3)),
            "reye_pose": 0.1 * rng.standard_normal((frames, 3)),
            "global_orient": 0.1 * rng.standard_normal((frames, 1, 3)),
            "body_pose_axis": 0.2 * rng.standard_normal((frames, 63)),
            "left_hand_pose": 0.5 * rng.standard_normal((frames, 45)),
            "right_hand_pose": 0.5 * rng.standard_normal((frames, 45)),
            "expression": 0.5 * rng.standard_normal((frames, 100)),
            "betas": 0.5 * rng.standard_normal((1, 300))}
    if nan:
        data["expression"][3, 7] = np.nan
    if drop_key:
        del data[drop_key]
    with open(os.path.join(d, name + ".pkl"), "wb") as f:
        pickle.dump(data, f)
    wav = os.path.join(d, name + ".wav")
    if bad_wav:
        with open(wav, "wb") as f:
            f.write(b"not a wav file")
    else:
        write_wav(wav, frames / 30.0, seed=seed)


@pytest.fixture(scope="module")
def show_root(tmp_path_factory):
    """Ten good clips of 96-120 frames over two speakers in the train
    split, and four the filter drops (60 frames, a NaN, an unreadable wav, a
    missing key) in another split, which the scan sees and the train split's
    loader does not."""
    root = str(tmp_path_factory.mktemp("show"))
    for i in range(10):
        _write_clip(root, ("oliver", "seth")[i % 2], f"v{i % 3}", "train", f"c{i}",
                    96 + 3 * i, i)
    _write_clip(root, "oliver", "v9", "raw", "short", 60, 20)
    _write_clip(root, "seth", "v9", "raw", "nan", 100, 21, nan=True)
    _write_clip(root, "seth", "v9", "raw", "badwav", 100, 22, bad_wav=True)
    _write_clip(root, "oliver", "v9", "raw", "nokey", 100, 23, drop_key="jaw_pose")
    return root


def test_preprocess_matches_jax(show_root, tmp_path):
    speakers = ["oliver", "seth", "conan"]
    scanned = tpre.scan_clips(show_root, speakers)
    assert scanned == jpre.scan_clips(show_root, speakers) and len(scanned) == 14
    kept = [c for c in scanned if tpre.check_clip(c[1], c[2])]
    assert kept == [c for c in scanned if jpre.check_clip(c[1], c[2])] and len(kept) == 10
    assert not any(os.path.basename(os.path.dirname(c[1])) in ("short", "nan", "badwav", "nokey")
                   for c in kept)
    for seed in (0, 3):
        got = tpre.preprocess(show_root, speakers, str(tmp_path / f"t{seed}.json"), seed=seed)
        want = jpre.preprocess(show_root, speakers, str(tmp_path / f"j{seed}.json"), seed=seed)
        assert got == want and [len(got[k]) for k in ("train", "val", "test")] == [8, 1, 1]
        assert json.load(open(tmp_path / f"t{seed}.json")) == json.load(
            open(tmp_path / f"j{seed}.json"))
    assert tpre.random_split(kept, seed=0) != tpre.random_split(kept, seed=3)
    nested = {"oliver": {"v0": {"train": ["x\\c0", "x\\c2"], "test": ["x\\c4"]}},
              "seth": {"v1": {"val": ["x\\c1"], "train": ["x\\c3"]}}}
    with open(tmp_path / "split.pkl", "wb") as f:
        pickle.dump(nested, f)
    smap = tpre.load_published_split(str(tmp_path / "split.pkl"))
    assert smap == jpre.load_published_split(str(tmp_path / "split.pkl"))
    assert tpre.apply_split(kept, smap) == jpre.apply_split(kept, smap)
    assert [len(v) for v in tpre.apply_split(kept, smap).values()] == [3, 1, 1]


def _config(path, model_name, pklname="_t.pkl", **model):
    cfg = {"Data": {"pose": {"generate_length": W}, "pklname": pklname},
           "Model": {"model_name": model_name, "code_num": 64, **model},
           "DataLoader": {"batch_size": B},
           "Train": {"epochs": 1, "learning_rate": {"generator_learning_rate": 1e-3}},
           "Log": {"save_every": 1, "print_every": 5, "name": "t"}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_train_cli_on_the_show_layout(show_root, tmp_path, monkeypatch):
    """main() without --synthetic: s2g_body_vq on the train split's MFCC
    windows (the cache written, then read instead of the clips), and
    s2g_face (faceformer) on its whole raw clips; no data and no
    --synthetic exits."""
    monkeypatch.setattr(cli, "VQVAE", lambda width, emb, nh: tv.VQVAE(width, emb, 16))
    monkeypatch.setattr(cli, "FaceGenerator",
                        lambda cfg=None: tface.FaceGenerator(tw2v.Wav2Vec2Config(**TINY)))
    speakers = ["--speakers", "oliver", "seth"]
    vq_cfg = _config(tmp_path / "vq.json", "s2g_body_vq")
    base = ["--epochs", "1", "--device", "cpu", "--data_root", show_root] + speakers
    counts.clear()
    vq = cli.main(["--config_file", vq_cfg, "--run_dir", str(tmp_path / "vq")] + base)
    clips = vq.dataset.clips
    assert len(clips) == 10 and clips[0].aud_feat.shape[-1] == 64
    assert {c.speaker for c in clips} == {"oliver", "seth"}
    assert vq.global_step >= 10 and counts["nearest_code_plain"] == 2 * vq.global_step
    cache = os.path.join(show_root, "train_t.pkl")
    assert os.path.isfile(cache)
    monkeypatch.setattr(tdata.ShowDataset, "load_clip",
                        staticmethod(lambda *a, **k: (_ for _ in ()).throw(AssertionError)))
    again = cli.main(["--config_file", vq_cfg, "--run_dir", str(tmp_path / "vq2"), "--epochs",
                      "0", "--device", "cpu", "--data_root", show_root] + speakers)
    assert [c.audio_path for c in again.dataset.clips] == [c.audio_path for c in clips]
    monkeypatch.undo()
    monkeypatch.setattr(cli, "FaceGenerator",
                        lambda cfg=None: tface.FaceGenerator(tw2v.Wav2Vec2Config(**TINY)))
    face_cfg = _config(tmp_path / "face.json", "s2g_face", "_raw.pkl",
                       encoder_choice="faceformer")
    face = cli.main(["--config_file", face_cfg, "--run_dir", str(tmp_path / "face")] + base)
    fclips = face.dataset.clips
    assert len(fclips) == 10 and all(c.aud_feat.shape[-1] == 1 for c in fclips)
    assert face.global_step == 10          # whole clips at batch 1
    hist = json.load(open(tmp_path / "face" / "history.json"))
    assert all(np.isfinite(v) for h in hist for v in h.values())
    with pytest.raises(SystemExit, match="--data_root"):
        cli.main(["--config_file", vq_cfg, "--run_dir", str(tmp_path / "none"), "--device",
                  "cpu"])

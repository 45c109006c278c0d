"""Run the full reference training schedule end to end through the port
(port of scripts/train_full_schedule.py).

The reference trains each stage for 100 epochs (config/*.json
`Train.epochs`): body-VQ and the pixel prior at batch 128 over stride-6
88-frame windows, the face stage at batch 1 over whole clips, plus the
body-AE FGD feature net (and, as an optional fifth trainable, the LS3DCG
baseline).  This drives the port's own train CLI
(`python -m talkshow_torch.train`'s `main`, in this process) for each stage
in dependency order on a structured synthetic SHOW tree
(`data/synthetic_show.py`, written when --data_root does not exist), then
the eval battery (`talkshow_torch.eval_full_schedule`), and publishes:

  * per-stage loss curves + throughput -> <run_root>/docs/<tag>_schedule/<stage>.history.json
  * the loss-curve plot                -> <run_root>/docs/<tag>_schedule/curves.png
    (skipped, with a message, where matplotlib is not installed)
  * the eval metrics, self-trained FGD against a random-init baseline
                                       -> <run_root>/EVAL_<tag>.json
  * status.json: per stage its state, wall seconds and the launches of
    each kernel (K1 ar_decode, K2 wav2vec_layers, K3 wav2vec_extractor, K4
    nearest_code) in it.

As in the JAX script, body_pixel and face train with --bf16 and face with
--face_bucket 30.  The stage configs are read from --config_dir (the
reference's config/*.json) when given; without it each is written from the
port's `Config` defaults (config.py's body_vq_config, body_pixel_config,
face_config, ls3dcg_config) under <run_root>/configs.

    python -m talkshow_torch.full_schedule                # full (hours)
    python -m talkshow_torch.full_schedule --smoke        # 2 epochs a stage
    python -m talkshow_torch.full_schedule --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import sys
import time

import numpy as np

from talkshow_torch import config as tconfig
from talkshow_torch.kernels import counts

#: stage -> its reference config file
CONFIG_FILES = {"body_vq": "body_vq.json", "body_pixel": "body_pixel.json",
                "face": "face.json", "ls3dcg": "LS3DCG.json"}
#: the kernels whose launches each stage records
KERNELS = ("ar_decode", "wav2vec_layers", "wav2vec_extractor", "nearest_code")
#: stage -> headline loss key in history.json
CURVE_KEYS = {"body_vq": "body_rec", "body_pixel": "ce_loss",
              "face": "loss", "body_ae": "rec_loss",
              "ls3dcg": "body_loss"}


class _Tee:
    """Writes to several streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run(name: str, fn, argv: list[str], log_path: str) -> tuple[float, dict]:
    """Call fn(argv) (a CLI's main) with its output and log records teed to
    log_path; returns (wall seconds, kernel launches during the call)."""
    t0 = time.time()
    print(f"[schedule] $ python -m {name} {' '.join(argv)}", flush=True)
    counts.clear()
    with open(log_path, "a") as lf:
        lf.write(f"\n$ python -m {name} {' '.join(argv)}\n")
        handler = logging.StreamHandler(lf)
        logging.getLogger().addHandler(handler)
        try:
            with contextlib.redirect_stdout(_Tee(sys.stdout, lf)):
                fn(argv)
        finally:
            logging.getLogger().removeHandler(handler)
    launches = {k: counts.get(k, 0) for k in KERNELS}
    dt = time.time() - t0
    print(f"[schedule] done in {dt:.0f}s; launches {launches}", flush=True)
    return dt, launches


def derived_config(src: str, dst: str, **model_overrides) -> str:
    """Reference config with Model.* overrides (e.g. the body-AE stage,
    which the reference trains from the body_vq envelope -- nets/body_ae.py
    has no dedicated config json)."""
    with open(src) as f:
        cfg = json.load(f)
    cfg["Model"].update(model_overrides)
    cfg["Log"]["name"] = model_overrides.get("model_name", "derived")
    with open(dst, "w") as f:
        json.dump(cfg, f, indent=1)
    return dst


_DEFAULTS = {"body_vq": tconfig.body_vq_config, "body_pixel": tconfig.body_pixel_config,
             "face": tconfig.face_config, "ls3dcg": tconfig.ls3dcg_config}


def stage_configs(config_dir: str | None, out_dir: str) -> dict:
    """stage -> config file: config_dir's reference files, or files written
    under out_dir from the port's Config defaults."""
    if config_dir:
        return {s: os.path.join(config_dir, f) for s, f in CONFIG_FILES.items()}
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for stage, fname in CONFIG_FILES.items():
        paths[stage] = os.path.join(out_dir, fname)
        with open(paths[stage], "w") as f:
            json.dump(_DEFAULTS[stage]().to_reference_dict(), f, indent=1)
    return paths


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m talkshow_torch.full_schedule")
    ap.add_argument("--data_root", default="experiments/r04_data")
    ap.add_argument("--run_root", default="experiments/r04_schedule")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the reference 100-epoch envelope")
    ap.add_argument("--smoke", action="store_true", help="2 epochs per stage")
    ap.add_argument("--stages", nargs="+",
                    default=["body_vq", "body_pixel", "face", "body_ae", "eval"])
    ap.add_argument("--tag", default="r05",
                    help="round tag: publishes <run_root>/docs/<tag>_schedule and "
                         "<run_root>/EVAL_<tag>.json")
    ap.add_argument("--smplx_npz", default="experiments/smplx_synthetic.npz",
                    help="SMPL-X npz for the eval battery's joint/vertex metrics "
                         "(a synthetic rig is written there if missing; '' disables)")
    ap.add_argument("--config_dir", default=None,
                    help="the reference's config/*.json; default: Config's defaults")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from talkshow_torch import eval_full_schedule
    from talkshow_torch.data.synthetic_show import write_show_tree
    from talkshow_torch.ops.smplx_lbs import build_synthetic_smplx_arrays
    from talkshow_torch.train.__main__ import main as train_main

    args = parse_args(argv)
    epochs = 2 if args.smoke else args.epochs   # None -> config (100)
    os.makedirs(args.run_root, exist_ok=True)
    status_path = os.path.join(args.run_root, "status.json")
    status = {"started": time.time(), "stages": {}}

    def mark(stage, **kv):
        status["stages"].setdefault(stage, {}).update(kv)
        with open(status_path, "w") as f:
            json.dump(status, f, indent=1)

    if not os.path.isdir(args.data_root):
        minutes = write_show_tree(args.data_root)
        print(f"[schedule] wrote {args.data_root}: {minutes:.1f} min of motion", flush=True)
    cfgs = stage_configs(args.config_dir, os.path.join(args.run_root, "configs"))
    ep = [] if epochs is None else ["--epochs", str(epochs)]

    def stage_last_epoch(cfg_path: str) -> int:
        """Train.epochs from the stage config (never assume 100), or the
        override, minus one."""
        if epochs is not None:
            return epochs - 1
        with open(cfg_path) as f:
            return int(json.load(f)["Train"]["epochs"]) - 1

    def train(stage, cfg, extra):
        rd = os.path.join(args.run_root, stage)
        mark(stage, state="running", t0=time.time())
        dt, launches = run("talkshow_torch.train", train_main,
                           ["--config_file", cfg, "--data_root", args.data_root, "--run_dir", rd,
                            "--device", args.device] + ep + extra,
                           os.path.join(args.run_root, f"{stage}.log"))
        mark(stage, state="done", wall_s=round(dt, 1), launches=launches)
        return rd

    if "body_vq" in args.stages:
        train("body_vq", cfgs["body_vq"], [])
    if "body_pixel" in args.stages:
        vq_ckpt = os.path.join(args.run_root, "body_vq",
                               f"ckpt-{stage_last_epoch(cfgs['body_vq'])}.pt")
        train("body_pixel", cfgs["body_pixel"], ["--vq_ckpt", vq_ckpt, "--bf16"])
    if "face" in args.stages:
        train("face", cfgs["face"], ["--face_bucket", "30", "--bf16"])
    if "body_ae" in args.stages:
        cfg = derived_config(cfgs["body_vq"], os.path.join(args.run_root, "body_ae.json"),
                             model_name="s2g_body_ae")
        train("body_ae", cfg, [])
    if "ls3dcg" in args.stages:   # optional 5th trainable (GAN baseline)
        train("ls3dcg", cfgs["ls3dcg"], [])

    results = None
    out = os.path.join(args.run_root, f"EVAL_{args.tag}.json")
    if "eval" in args.stages:
        if args.smplx_npz and not os.path.exists(args.smplx_npz):
            os.makedirs(os.path.dirname(os.path.abspath(args.smplx_npz)), exist_ok=True)
            np.savez(args.smplx_npz, **build_synthetic_smplx_arrays())
        mark("eval", state="running", t0=time.time())
        dt, launches = run(
            "talkshow_torch.eval_full_schedule", eval_full_schedule.main,
            ["--data_root", args.data_root, "--run_root", args.run_root,
             "--last_epoch", str(stage_last_epoch(cfgs["body_pixel"])),
             "--smplx_npz", args.smplx_npz, "--cache_tag", args.tag, "--out", out,
             "--device", args.device] + (["--config_dir", args.config_dir]
                                         if args.config_dir else []),
            os.path.join(args.run_root, "eval.log"))
        mark("eval", state="done", wall_s=round(dt, 1), launches=launches)
        with open(out) as f:
            results = json.load(f)

    # ---- publish ----
    pub = os.path.join(args.run_root, "docs", f"{args.tag}_schedule")
    os.makedirs(pub, exist_ok=True)
    for stage in CURVE_KEYS:
        h = os.path.join(args.run_root, stage, "history.json")
        if os.path.exists(h):
            shutil.copy(h, os.path.join(pub, f"{stage}.history.json"))
    plot_curves(args.run_root, os.path.join(pub, "curves.png"))
    status["finished"] = time.time()
    with open(status_path, "w") as f:
        json.dump(status, f, indent=1)
    print("[schedule] complete", flush=True)
    return {"status": status, "eval": results}


def plot_curves(run_root: str, out_png: str) -> bool:
    """The headline loss per epoch of each trained stage, one panel each,
    log scale.  Without matplotlib it prints that the plot was skipped and
    returns False: no result depends on it."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"[schedule] curve plot skipped: {e}")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    present = [(s, k) for s, k in CURVE_KEYS.items()
               if os.path.exists(os.path.join(run_root, s, "history.json"))]
    fig, axes = plt.subplots(1, max(1, len(present)), figsize=(4 * max(1, len(present)), 3.2))
    axes = axes if hasattr(axes, "__len__") else [axes]
    for ax, (stage, key) in zip(axes, present):
        with open(os.path.join(run_root, stage, "history.json")) as f:
            hist = json.load(f)
        ys = [e.get(key) for e in hist if e.get(key) is not None]
        ax.plot(range(len(ys)), ys)
        ax.set_title(f"{stage}: {key}")
        ax.set_xlabel("epoch")
        ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    print(f"[schedule] wrote {out_png}")
    return True


if __name__ == "__main__":
    main()

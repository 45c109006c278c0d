"""Evaluate the port's stages (mirror of scripts/test_vq.py, test_body.py and
test_face.py).

    python -m talkshow_torch.eval vq --vq_ckpt experiments/body-vq/ckpt-0.pt \
        [--data_root <SHOW> | --synthetic]
    python -m talkshow_torch.eval body --body_ckpt <pixel ckpt> --vq_ckpt <vq ckpt> \
        --ae_ckpt experiments/body-ae/ckpt-0.pt [--smplx_npz SMPLX_NEUTRAL_2020.npz]
    python -m talkshow_torch.eval face --face_ckpt <face ckpt> [--smplx_npz ...]

Each prints one JSON line of the runner's metrics (`eval/runners.py`).
Runs on the card unless `--device cpu` is given, with TF32 off (f32 sums,
as the JAX package computes on the CPU).  A checkpoint is either this
port's own (a `ckpt-*.pt` of `python -m talkshow_torch.train`) or the
reference trainer's `.pth`.  Without a checkpoint the stage's weights are
random (a NOTE says so; without --ae_ckpt FGD uses a random feature net, and
a WARNING says so).  Without --data_root, or with --synthetic, the data is
the JAX scripts' synthetic clips; else the SHOW test split under
--data_root (`ShowDataset.from_root`).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from talkshow_torch import convert
from talkshow_torch.data.dataset import ShowDataset, synthetic_dataset
from talkshow_torch.eval.runners import eval_body, eval_face, eval_vq_capacity
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.vqvae import AE, VQVAE
from talkshow_torch.ops.pose import BODY_DIM, CONV_DIM, HAND_DIM
from talkshow_torch.ops.smplx_lbs import load_smplx_npz
from talkshow_torch.ops.vq import VQState
from talkshow_torch.pipeline import Pipeline
from talkshow_torch.train.steps import make_body_vq_step

SPEAKERS = ["oliver", "chemistry", "seth", "conan"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.eval")
    p.add_argument("runner", choices=("vq", "body", "face"))
    p.add_argument("--data_root", default=None)
    p.add_argument("--speakers", nargs="+", default=SPEAKERS)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--face_ckpt", default=None)
    p.add_argument("--body_ckpt", default=None, help="s2g_body_pixel checkpoint")
    p.add_argument("--vq_ckpt", default=None, help="s2g_body_vq checkpoint")
    p.add_argument("--ae_ckpt", default=None, help="s2g_body_ae checkpoint (the FGD net)")
    p.add_argument("--smplx_npz", default=None)
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _own(ckpt: dict) -> dict | None:
    """The train state of this port's checkpoint, or None for a reference file."""
    return ckpt["state"] if "state" in ckpt and "generator" not in ckpt else None


def vq_weights(ckpt: dict) -> dict:
    """A stage-1 checkpoint -> {'vq_body', 'vq_hand', 'vq_body_state', 'vq_hand_state'}."""
    state = _own(ckpt)
    if state is None:
        return convert.reference_body_vq(ckpt)
    out = {f"vq_{k}": sd for k, sd in state["models"].items()}
    out.update({f"vq_{k}_state": VQState(**s) for k, s in state["vq"].items()})
    return out


def pixel_weights(ckpt: dict) -> dict:
    """A stage-2 checkpoint -> {'prior', 'audio_enc'} (+ the VQs a reference
    file may hold)."""
    state = _own(ckpt)
    if state is None:
        out = convert.reference_body_pixel(ckpt)
        if "g_body" in ckpt.get("generator", ckpt):
            out.update(convert.reference_body_vq(ckpt))
        return out
    return {"prior": state["models"]["prior"], "audio_enc": state["models"]["audio"]}


def face_weights(ckpt: dict) -> dict:
    state = _own(ckpt)
    return {"face": convert.reference_face(ckpt) if state is None else state["face"]}


def ae_weights(ckpt: dict) -> dict:
    state = _own(ckpt)
    return convert.reference_body_ae(ckpt) if state is None else state["model"]


def dataset(args, frames: int, num_clips: int, feat: str = "mfcc"):
    if args.synthetic or not args.data_root:
        return synthetic_dataset(num_clips=num_clips, frames=frames)
    return ShowDataset.from_root(args.data_root, args.speakers, "test", feat=feat,
                                 device=args.device)


def run_vq(args) -> dict:
    dev = torch.device(args.device)
    vq_body, vq_hand = VQVAE(BODY_DIM), VQVAE(HAND_DIM)
    init_state, _ = make_body_vq_step(vq_body, vq_hand)
    states = init_state(torch.Generator().manual_seed(0), dev).vq
    if args.vq_ckpt:
        w = vq_weights(_load(args.vq_ckpt))
        vq_body.load_state_dict(w["vq_body"])
        vq_hand.load_state_dict(w["vq_hand"])
        states = {k: w[f"vq_{k}_state"].to(dev) for k in ("body", "hand")}
    else:
        print("NOTE: random weights (no --vq_ckpt)")
    return eval_vq_capacity(vq_body, vq_hand, states, dataset(args, 240, 4))


def run_body(args) -> dict:
    dev = torch.device(args.device)
    pipe = Pipeline.create(0, dev)
    if args.body_ckpt or args.vq_ckpt:
        weights = pixel_weights(_load(args.body_ckpt)) if args.body_ckpt else {}
        if args.vq_ckpt:
            weights.update(vq_weights(_load(args.vq_ckpt)))
        pipe.load_converted(weights)
    else:
        print("NOTE: random weights")
    ae = AE(CONV_DIM)
    if args.ae_ckpt:
        ae.load_state_dict(ae_weights(_load(args.ae_ckpt)))
    else:
        print("WARNING: --ae_ckpt not given; FGD uses a RANDOM-INIT feature extractor and "
              "is NOT comparable to the reference", file=sys.stderr)
        init_weights_(ae, torch.Generator().manual_seed(1))
    ae.to(dev)
    smplx_model = load_smplx_npz(args.smplx_npz, device=dev) if args.smplx_npz else None
    return eval_body(pipe, ae, dataset(args, 240, 4), num_samples=args.num_samples,
                     smplx_model=smplx_model)


def run_face(args) -> dict:
    dev = torch.device(args.device)
    pipe = Pipeline.create(0, dev)
    if args.face_ckpt:
        pipe.load_converted(face_weights(_load(args.face_ckpt)))
    else:
        print("NOTE: random weights")
    if args.synthetic or not args.data_root:
        ds = synthetic_dataset(num_clips=2, frames=90)
        for c in ds.clips:  # face eval consumes the raw-waveform feature
            c.aud_feat = np.random.default_rng(0).standard_normal(
                (c.poses.shape[0] * 16000 // 30, 1)).astype(np.float32)
    else:
        ds = dataset(args, 0, 0, feat="raw")
    smplx_model = load_smplx_npz(args.smplx_npz, device=dev) if args.smplx_npz else None
    return eval_face(pipe.face_model, ds, smplx_model)


RUNNERS = {"vq": run_vq, "body": run_body, "face": run_face}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = RUNNERS[args.runner](args)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

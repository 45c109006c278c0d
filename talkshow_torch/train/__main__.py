"""Train a stage of the port (mirror of scripts/train.py for s2g_body_vq).

    python -m talkshow_torch.train --config_file config/body_vq.json \
        --synthetic --epochs 1 --run_dir experiments/body-vq [--device cpu]

Runs on the card unless `--device cpu` is given, with TF32 off (f32 sums,
as the JAX package computes on the CPU) and deterministic cuDNN.  The
synthetic dataset holds at least SYNTHETIC_STEPS batches per epoch at the
config's batch size and window, and the VQ-VAEs have the config's
`vq_num_hiddens` (1024), as scripts/train.py builds them.  The stage comes
from the config's Model.model_name; only stage 1, s2g_body_vq, is ported: any other
stage raises and names the ROADMAP.md item that ports it.  Only synthetic
data is supported until the SHOW dataset loader is ported.
"""
from __future__ import annotations

import argparse
import logging

import torch

from talkshow_torch.config import Config
from talkshow_torch.data.dataset import synthetic_dataset
from talkshow_torch.models.vqvae import VQVAE
from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
from talkshow_torch.train.steps import make_body_vq_step
from talkshow_torch.train.trainer import Trainer

NOT_PORTED = {
    "s2g_body_pixel": "ROADMAP.md Queue 1 item 3 (the body-pixel step)",
    "s2g_face": "ROADMAP.md Queue 1 item 4 (the face step)",
    "s2g_body_ae": "ROADMAP.md Queue 1 item 7 (the body-AE step)",
    "s2g_LS3DCG": "ROADMAP.md Queue 1 item 7 (the LS3DCG step)",
}
#: least batches per epoch of the synthetic dataset, whatever the batch size
SYNTHETIC_STEPS = 10


def synthetic_for(cfg: Config):
    """Four synthetic clips (as scripts/train.py), each long enough for at
    least a quarter of SYNTHETIC_STEPS batches of stride-6 windows."""
    L = cfg.data.pose.generate_length
    per_clip = -(-SYNTHETIC_STEPS * cfg.train.batch_size // 4)
    ds = synthetic_dataset(num_clips=4, frames=L + 6 * per_clip)
    ds.generate_length = L
    return ds


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.train")
    p.add_argument("--config_file", required=True,
                   help="reference-format JSON config (config/*.json)")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", default=None, help="checkpoint file to resume")
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic dataset (the only data source ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = Config.from_reference_json(args.config_file)
    cfg.train.seed = args.seed
    name = cfg.model.model_name
    if name in NOT_PORTED:
        raise SystemExit(f"stage {name} is not ported to talkshow_torch yet: {NOT_PORTED[name]}")
    if cfg.data.pose.convert_to_6d:
        raise SystemExit("the 6-D pose variant is not ported yet: ROADMAP.md Queue 1 item 7")
    if not args.synthetic:
        raise SystemExit("loading the SHOW dataset is not ported yet (ROADMAP.md Queue 1 "
                         "item 7); pass --synthetic")
    device = torch.device(args.device)
    if device.type == "cuda":
        # f32 sums, and deterministic cuDNN algorithms, so that a resumed
        # run equals an uninterrupted one bit for bit
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    ds = synthetic_for(cfg)
    print(f"dataset: {len(ds.clips)} clips")
    vq_body = VQVAE(BODY_DIM, cfg.model.vq_embedding_dim, cfg.model.vq_num_hiddens)
    vq_hand = VQVAE(HAND_DIM, cfg.model.vq_embedding_dim, cfg.model.vq_num_hiddens)
    init_state, step = make_body_vq_step(vq_body, vq_hand, cfg.train.generator_learning_rate,
                                         code_num=cfg.model.code_num)
    run_dir = args.run_dir or f"experiments/{cfg.log.name}"
    trainer = Trainer(cfg, ds, init_state, step, run_dir=run_dir, device=device,
                      batch_keys=("poses",)).setup()
    if args.resume:
        trainer.resume(args.resume)
    trainer.train(epochs=args.epochs)
    print(f"done; checkpoints in {run_dir}")
    return trainer


if __name__ == "__main__":
    main()

"""Train a stage of the port (mirror of scripts/train.py).

    python -m talkshow_torch.train --config_file config/body_vq.json \
        --data_root /path/to/ExpressiveWholeBodyDatasetv1.0 \
        --speakers oliver seth conan chemistry --run_dir experiments/body-vq
    python -m talkshow_torch.train --config_file config/body_vq.json \
        --synthetic --epochs 1 --run_dir experiments/body-vq [--device cpu]
    python -m talkshow_torch.train --config_file config/body_pixel.json \
        --synthetic --vq_ckpt experiments/body-vq/ckpt-0.pt [--no_token_cache]
    python -m talkshow_torch.train --config_file config/face.json \
        --synthetic [--face_bucket 32 --face_batch_size 2]
    python -m talkshow_torch.train --config_file config/LS3DCG.json --synthetic

Runs on the card unless `--device cpu` is given, with TF32 off (f32 sums,
as the JAX package computes on the CPU) and deterministic cuDNN.  The stage
comes from the config's Model.model_name:

- s2g_body_vq: the VQ-VAEs at the config's `vq_num_hiddens` (1024), as
  scripts/train.py builds them;
- s2g_body_pixel: the prior (`pixelcnn_dim`, `pixelcnn_layers`,
  `num_speakers`, `bh_model`: false trains the vertical-only prior, which
  no sampler of either package runs) and a 256-wide audio encoder on the
  token grids of the
  stage-1 VQs of `--vq_ckpt` (a `ckpt-*.pt` of this trainer's s2g_body_vq
  run) or Model.vq_path, cached per window unless `--no_token_cache`;
- s2g_face: the face generator (wav2vec 2.0 base) on whole clips at batch
  1, or `--face_bucket` frames' length buckets of `--face_batch_size`;
- `--bf16`: s2g_body_pixel's prior and s2g_face's wav2vec stack and
  feature map compute in bf16 (f32 parameters, optimizer state, losses and
  checkpoints; the face step's frozen extractor runs K3 on bf16 tables), as
  scripts/train.py:47-50 says; the other stages ignore it;
- s2g_body_ae: the body AE, the FGD feature net (`AE(in_dim=129,
  num_hiddens=vq_num_hiddens)`, as scripts/train.py:172-178), on the
  windows' poses at the generator learning rate;
- s2g_LS3DCG: the LS3DCG generator and discriminator, the LSGAN step with
  `keypoint_loss_weight` and `gan_loss_weight` (scripts/train.py:179-187).

Codebooks: every VQ-VAE is built at `vq_embedding_dim` and every codebook
with `code_num` codes, in stage 1 and in the frozen VQs of stage 2, so the
two stages agree for any config.  That departs from JAX where `code_num`
is not 2048 or `vq_embedding_dim` not 64: JAX's stage 1 always builds
2048 codes (talkshow_tpu/train/steps.py:55-56), while its stage 2 takes
`code_num` logits over frozen VQ-VAEs of width 64 (scripts/train.py:126-127,146).
At the reference defaults (2048 codes of width 64) the two agree.

With Data.pose.convert_to_6d the poses are the 6-D variant's (T, 330): the
VQ-VAEs take 78 / 180 channels and the s2g_body_pixel prior is 512 wide
and 10 layers deep, as scripts/train.py:109-158 builds it.

Several devices: the config's "parallel" entry ({"dp": D, "tp": P}; 1 x 1
when absent) sets the mesh, and the CLI runs as one of D * P ranks under
torchrun, which sets WORLD_SIZE, RANK and LOCAL_RANK:

    torchrun --nproc_per_node 4 -m talkshow_torch.train \
        --config_file body_vq_dp2_tp2.json --synthetic [--device cpu]

The process group's backend follows the devices: "nccl" when this host has
a card for every rank (rank i on card LOCAL_RANK), "gloo" for CPU ranks or
for ranks sharing fewer cards (a line says which).  Every stage runs on
the mesh.  s2g_face takes whole clips (one a batch, K3 on every rank)
under tp alone; with dp > 1 it needs `--face_bucket N --face_batch_size B`
with B a multiple of dp, and every bucket's batches full (a batch whose
rows do not split over dp raises ValueError, as JAX's device_put does):

    torchrun --nproc_per_node 2 -m talkshow_torch.train \
        --config_file face_tp2.json --synthetic     # "parallel": {"dp": 1, "tp": 2}

Data: the SHOW layout under `--data_root` (or Data.data_root), the train
split of `--speakers`, through `ShowDataset.from_root` with its cache at
<data_root>/train<Data.pklname>: the MFCC for every stage but the
faceformer face stage, which reads the raw 16 kHz waveform of whole clips.
With `--synthetic`, the window stages' synthetic dataset holds at least
SYNTHETIC_STEPS batches per epoch at the config's batch size and window
(its poses in the 6-D layout when the config asks); the face stage's is
the four raw-waveform clips of about 8 s that scripts/train.py makes.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from talkshow_torch.config import Config
from talkshow_torch.data.dataset import (ShowDataset, synthetic_dataset,
                                         synthetic_face_dataset)
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.ls3dcg import LS3DCGDiscriminator, LS3DCGGenerator
from talkshow_torch.models.pixelcnn import GatedPixelCNN
from talkshow_torch.models.vqvae import AE, VQVAE, AudioEncoder
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops.pose import (BODY_DIM, CONV_DIM, HAND_DIM, SPEAKER_ID,
                                    axis_angle_poses_to_6d)
from talkshow_torch.ops.vq import VQState
from talkshow_torch.parallel import multihost
from talkshow_torch.train.steps import (make_body_ae_step, make_body_pixel_step,
                                        make_body_vq_step, make_face_step,
                                        make_ls3dcg_step, make_token_encoder)
from talkshow_torch.train.trainer import Trainer

#: least batches per epoch of the synthetic dataset, whatever the batch size
SYNTHETIC_STEPS = 10
#: the 6-D variant's prior (smplx_body_pixel.py:49-53, scripts/train.py:143-145)
PRIOR_6D = dict(dim=512, n_layers=10)


def synthetic_for(cfg: Config):
    """Four synthetic clips (as scripts/train.py), each long enough for at
    least a quarter of SYNTHETIC_STEPS batches of stride-6 windows; with
    Data.pose.convert_to_6d their poses are converted to the 6-D layout."""
    L = cfg.data.pose.generate_length
    per_clip = -(-SYNTHETIC_STEPS * cfg.train.batch_size // 4)
    ds = synthetic_dataset(num_clips=4, frames=L + 6 * per_clip)
    ds.generate_length = L
    if cfg.data.pose.convert_to_6d:
        for c in ds.clips:
            c.poses = axis_angle_poses_to_6d(torch.as_tensor(c.poses)).numpy()
    return ds


def show_dataset(cfg: Config, args, feat: str) -> ShowDataset:
    """The train split of the SHOW layout under --data_root (or
    Data.data_root), as scripts/train.py:100-106 loads it."""
    root = cfg.data.data_root
    if not root:
        raise SystemExit("no data: pass --data_root <SHOW layout> (or set Data.data_root), "
                         "or --synthetic")
    return ShowDataset.from_root(root, args.speakers, "train", feat=feat,
                                 cache_pkl=os.path.join(root, "train" + cfg.data.pklname),
                                 generate_length=cfg.data.pose.generate_length,
                                 convert_to_6d=cfg.data.pose.convert_to_6d, device=args.device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.train")
    p.add_argument("--config_file", required=True,
                   help="reference-format JSON config (config/*.json)")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--resume", default=None, help="checkpoint file to resume")
    p.add_argument("--data_root", default=None,
                   help="the SHOW layout (<speaker>/<video>/<split>/<clip>/); default "
                        "Data.data_root")
    p.add_argument("--speakers", nargs="+", default=list(SPEAKER_ID))
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic dataset instead of --data_root")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--vq_ckpt", default=None,
                   help="s2g_body_pixel: the stage-1 checkpoint (ckpt-*.pt of an s2g_body_vq "
                        "run); default Model.vq_path")
    p.add_argument("--no_token_cache", action="store_true",
                   help="s2g_body_pixel: encode every batch's tokens in the step instead of "
                        "caching them per window (the same numbers)")
    p.add_argument("--face_bucket", type=int, default=0,
                   help="s2g_face: round clip lengths up to multiples of this many frames "
                        "and batch clips of one bucket")
    p.add_argument("--face_batch_size", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision for s2g_body_pixel and s2g_face: bf16 compute at "
                        "flax's sites (f32 parameters, optimizer state and losses); the other "
                        "stages ignore it")
    return p.parse_args(argv)


def frozen_vqs(cfg: Config, path: str, scale: int = 1) -> tuple:
    """(vq_body, vq_hand, {'body', 'hand': VQState}) from a stage-1
    checkpoint of this trainer, at the config's widths (x2 in the 6-D
    variant, `scale`), on the host."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["state"]
    vqs = []
    for part, width in (("body", BODY_DIM), ("hand", HAND_DIM)):
        vq = VQVAE(width * scale, cfg.model.vq_embedding_dim, cfg.model.vq_num_hiddens)
        vq.load_state_dict(sd["models"][part])
        vqs.append(vq.eval())
    return (*vqs, {k: VQState(**s) for k, s in sd["vq"].items()})


def build_stage(cfg: Config, args) -> dict:
    """The stage's dataset, state and step, and how the trainer feeds it:
    keyword arguments of Trainer."""
    name = cfg.model.model_name
    lr = cfg.train.generator_learning_rate
    dtype = torch.bfloat16 if args.bf16 else None
    rep6d = cfg.data.pose.convert_to_6d
    scale = 2 if rep6d else 1
    feat = "raw" if cfg.model.encoder_choice == "faceformer" else "mfcc"

    def windows():
        return synthetic_for(cfg) if args.synthetic else show_dataset(cfg, args, feat)

    if name == "s2g_body_vq":
        vq_body = VQVAE(BODY_DIM * scale, cfg.model.vq_embedding_dim, cfg.model.vq_num_hiddens)
        vq_hand = VQVAE(HAND_DIM * scale, cfg.model.vq_embedding_dim, cfg.model.vq_num_hiddens)
        init_state, step = make_body_vq_step(vq_body, vq_hand, lr, code_num=cfg.model.code_num,
                                             rep6d=rep6d)
        return dict(dataset=windows(), init_state_fn=init_state, step_fn=step,
                    batch_keys=("poses",))
    if name == "s2g_body_pixel":
        path = args.vq_ckpt or cfg.model.vq_path
        if not path:
            raise SystemExit("s2g_body_pixel needs the stage-1 VQs: pass --vq_ckpt (a ckpt-*.pt "
                             "of an s2g_body_vq run) or set Model.vq_path")
        vq_body, vq_hand, states = frozen_vqs(cfg, path, scale)
        width = PRIOR_6D if rep6d else dict(dim=cfg.model.pixelcnn_dim,
                                            n_layers=cfg.model.pixelcnn_layers)
        prior = GatedPixelCNN(input_dim=cfg.model.code_num, n_classes=cfg.model.num_speakers,
                              bh_model=cfg.model.bh_model, dtype=dtype, **width)
        init_state, step = make_body_pixel_step(prior, AudioEncoder(num_hiddens=256), vq_body,
                                                vq_hand, states, lr,
                                                cfg.train.max_gradient_norm, rep6d=rep6d)
        encoder = None if args.no_token_cache else make_token_encoder(vq_body, vq_hand, states,
                                                                      rep6d)
        return dict(dataset=windows(), init_state_fn=init_state, step_fn=step,
                    batch_keys=("poses", "aud_feat", "speaker"), needs_rng=True,
                    token_encoder=encoder)
    if name == "s2g_face":
        # the JAX CLI's face step runs at make_face_step's default lr, 1e-3
        init_state, step = make_face_step(FaceGenerator(Wav2Vec2Config(dtype=dtype)),
                                          max_grad_norm=cfg.train.max_gradient_norm)
        ds = (synthetic_face_dataset(num_clips=4, frames=240, bucketed=bool(args.face_bucket))
              if args.synthetic else show_dataset(cfg, args, feat))
        return dict(dataset=ds, init_state_fn=init_state, step_fn=step, needs_rng=True,
                    batch_mode="face_clips", face_bucket_frames=args.face_bucket,
                    face_batch_size=args.face_batch_size)
    if name == "s2g_body_ae":
        ae = AE(CONV_DIM, num_hiddens=cfg.model.vq_num_hiddens)
        init_state, step = make_body_ae_step(ae, lr)
        return dict(dataset=windows(), init_state_fn=init_state, step_fn=step,
                    batch_keys=("poses",))
    if name == "s2g_LS3DCG":
        init_state, step = make_ls3dcg_step(LS3DCGGenerator(), LS3DCGDiscriminator(), lr,
                                            cfg.train.keypoint_loss_weight,
                                            cfg.train.gan_loss_weight)
        return dict(dataset=windows(), init_state_fn=init_state, step_fn=step,
                    batch_keys=("poses", "expression", "aud_feat"))
    raise SystemExit(f"unknown stage {name}")


def main(argv=None) -> Trainer:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = parse_args(argv)
    cfg = Config.from_reference_json(args.config_file)
    if args.data_root:
        cfg.data.data_root = args.data_root
    cfg.train.seed = args.seed
    device = torch.device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = start_process_group(device)
    if device.type == "cuda":
        # f32 sums, and deterministic cuDNN algorithms, so that a resumed
        # run equals an uninterrupted one bit for bit
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    stage = build_stage(cfg, args)
    print(f"dataset: {len(stage['dataset'].clips)} clips")
    run_dir = args.run_dir or f"experiments/{cfg.log.name}"
    trainer = Trainer(cfg, run_dir=run_dir, device=device, **stage).setup()
    if args.resume:
        trainer.resume(args.resume)
    trainer.train(epochs=args.epochs)
    if trainer.lead:
        print(f"done; checkpoints in {run_dir}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return trainer


def start_process_group(device: torch.device) -> torch.device:
    """Join torchrun's process group; returns this rank's device.  NCCL
    when every rank on this host has a card of its own, else gloo (CPU
    ranks, or ranks that share a card)."""
    here = multihost.local_world_size()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "nccl" if device.type == "cuda" and cards >= here else "gloo"
    multihost.initialize_multihost(backend=backend)
    device = multihost.rank_device(device.type)
    print(f"rank {dist.get_rank()} of {dist.get_world_size()}: {backend} on {device} "
          f"({here} ranks and {cards} card(s) on this host)")
    return device


if __name__ == "__main__":
    main()

"""Chunked long-audio generation demo (the port of scripts/continuity.py):
the first 2 s are generated, then the whole clip is sampled again with the
first chunk's tokens as a teacher-forced prefix (two AR decodes, K1 twice
on the card).

    python -m talkshow_torch.continuity --audio_file long.wav [--tiny] [--device cpu]

Saves (T, 265) as `<out_dir>/<stem>_continuity.npy`.  --tiny builds random
models at the JAX script's tiny widths.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.pipeline import Pipeline

#: the JAX script's --tiny models (scripts/continuity.py:34-40)
TINY_W2V = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
                conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
TINY_BODY = dict(num_hiddens=64, pixel_dim=16, pixel_layers=3, code_num=64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.continuity")
    p.add_argument("--audio_file", required=True)
    p.add_argument("--id", type=int, default=0)
    p.add_argument("--out_dir", default="visualise/video/continuity")
    p.add_argument("--face_ckpt", default=None)
    p.add_argument("--body_ckpt", default=None)
    p.add_argument("--vq_ckpt", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (a smoke run; no checkpoints)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Run the continuity demo; returns the (1, T, 265) motion it saved."""
    args = parse_args(argv)
    if args.body_ckpt:
        pipe = Pipeline.from_torch_checkpoints(args.face_ckpt, args.body_ckpt, args.vq_ckpt,
                                               device=args.device)
    elif args.tiny:
        print("NOTE: tiny random weights (smoke mode)")
        pipe = Pipeline.create(0, args.device, Wav2Vec2Config(**TINY_W2V), **TINY_BODY)
    else:
        print("NOTE: random weights")
        pipe = Pipeline.create(0, args.device)
    motion = pipe.generate(args.audio_file, speaker=args.id, num_samples=1, continuity=True)
    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.audio_file))[0]
    out = os.path.join(args.out_dir, stem + "_continuity.npy")
    np.save(out, motion.reshape(-1, motion.shape[-1]))
    print(f"saved {motion.shape} -> {out}")
    return motion


if __name__ == "__main__":
    main()

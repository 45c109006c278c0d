"""Diversity sampling demo: N samples x 4 speakers from one clip (the port of
scripts/diversity.py), with an optional grid video; 4 speakers x 3
samples land on the reference's 12-tile 4 x 3 layout.

    python -m talkshow_torch.diversity --audio_file clip.wav --num_sample 3 \
        [--render --smplx_npz SMPLX_NEUTRAL_2020.npz] [--tiny] [--device cpu]

Each speaker's samples come from one AR decode (K1 on the card) seeded by
the speaker index, as in JAX.  Prints one JSON line of the per-speaker
diversity (`eval/metrics.diversity`) and saves the conv poses (4, S, T, 129)
as `<out_dir>/<stem>_diversity.npy`; --render adds the face stage once (the
demo's face is speaker-independent) and writes `<stem>_grid.mp4`.
--tiny builds random models at the JAX script's tiny widths.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from talkshow_torch.eval.metrics import diversity
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.pipeline import Pipeline

#: the JAX script's --tiny models (scripts/diversity.py:44-51)
TINY_W2V = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
TINY_BODY = dict(code_num=64, embedding_dim=16, num_hiddens=32, pixel_dim=32, pixel_layers=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.diversity")
    p.add_argument("--audio_file", required=True)
    p.add_argument("--num_sample", type=int, default=3)
    p.add_argument("--out_dir", default="visualise/video/diversity")
    p.add_argument("--face_ckpt", default=None)
    p.add_argument("--body_ckpt", default=None)
    p.add_argument("--vq_ckpt", default=None)
    p.add_argument("--render", action="store_true",
                   help="render the full 4 x num_sample grid video")
    p.add_argument("--smplx_npz", default=None)
    p.add_argument("--render_mode", default="whole_body",
                   choices=["default", "whole_body", "face"])
    p.add_argument("--tiny", action="store_true",
                   help="random-init tiny models (a smoke run; fast on the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sampler; returns the per-speaker diversity it printed."""
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

    with torch.no_grad():
        feat = audio_ops.get_mfcc(args.audio_file, sr=22000, fps=30,
                                  device=pipe.device).cpu().numpy()
    all_motion, scores = [], {}
    for speaker in range(4):
        conv = pipe.generate_body(feat, speaker, num_samples=args.num_sample, seed=speaker)
        scores[f"diversity_speaker{speaker}"] = diversity(conv)
        all_motion.append(conv)
    motion = np.stack(all_motion)          # (4, S, T, 129)

    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.audio_file))[0]
    np.save(os.path.join(args.out_dir, stem + "_diversity.npy"), motion)

    if args.render:
        from talkshow_torch.render import render_motion_video
        wav16, sr0 = audio_ops.load_wav(args.audio_file)
        if sr0 != 16000:
            wav16 = audio_ops.resample(torch.as_tensor(wav16), sr0, 16000).numpy()
        face_out = pipe.generate_face(wav16)
        full = np.concatenate([pipe.assemble_full(face_out, motion[s]) for s in range(4)])
        render_motion_video(full, args.audio_file,
                            os.path.join(args.out_dir, stem + "_grid.mp4"),
                            smplx_npz=args.smplx_npz, mode=args.render_mode, device=pipe.device)
    print(json.dumps(scores))
    return scores


if __name__ == "__main__":
    main()

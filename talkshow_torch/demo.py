"""wav -> SMPL-X motion (+ optional video): the port of scripts/demo.py.

    python -m talkshow_torch.demo --audio_file demo_audio/1st-page.wav --id 0 \
        --num_sample 3 --out_dir visualise/video/demo [--device cpu]

Loads the reference trainer's `.pth` checkpoints when given (--face_ckpt /
--body_ckpt / --vq_ckpt, converted on load by `talkshow_torch.convert`),
otherwise random weights from --seed.  Runs on the card unless `--device
cpu` is given: the face stage on K3 + K2, the AR decode on K1.  Saves the
generated (S, T, 265) motion as `<out_dir>/<stem>.npy` with the samples
concatenated on time, (S * T, 265), as the reference demo does
(scripts/demo.py:242-245); --render writes `<stem>.mp4`
(`talkshow_torch.render`, which needs cv2 and an SMPL-X npz).

--model ls3dcg generates with the LS3DCG baseline instead: its generator
from --ls3dcg_ckpt, a checkpoint of this port's `s2g_LS3DCG` train stage
(`python -m talkshow_torch.train`), or random weights.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.ls3dcg import LS3DCGGenerator, infer_on_audio
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.pipeline import Pipeline
from talkshow_torch.streaming import StreamingSession

#: samples of 16 kHz audio fed to the streaming session at a time
STREAM_FEED = 16000


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.demo")
    p.add_argument("--audio_file", required=True)
    p.add_argument("--id", type=int, default=0,
                   help="speaker id 0-3 (oliver/chemistry/seth/conan)")
    p.add_argument("--num_sample", type=int, default=1)
    p.add_argument("--only_face", action="store_true")
    p.add_argument("--stand", action="store_true")
    p.add_argument("--continuity", action="store_true",
                   help="chunked AR continuation for long audio")
    p.add_argument("--streaming", action="store_true",
                   help="sliding-window streaming generation, fed 1 s at a time "
                        "(talkshow_torch/streaming.py)")
    p.add_argument("--face_ckpt", default=None, help="reference face .pth")
    p.add_argument("--body_ckpt", default=None, help="reference body-pixel .pth")
    p.add_argument("--vq_ckpt", default=None, help="reference body-vq .pth")
    p.add_argument("--out_dir", default="visualise/video/demo")
    p.add_argument("--render", action="store_true",
                   help="render a video (needs cv2 and --smplx_npz)")
    p.add_argument("--render_mode", default="whole_body",
                   choices=["default", "whole_body", "face"],
                   help="camera mode (the reference demo renders whole_body)")
    p.add_argument("--smplx_npz", default=None)
    p.add_argument("--model", default="talkshow", choices=["talkshow", "ls3dcg"])
    p.add_argument("--ls3dcg_ckpt", default=None,
                   help="ckpt-*.pt of the port's s2g_LS3DCG train stage")
    p.add_argument("--norm_stats", default=None,
                   help="norm_stats.npy for models trained with Data.pose.normalization")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--face_f32", action="store_true",
                   help="f32 face tables for K3 and K2 (bf16 by default on the card)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _ls3dcg(args) -> np.ndarray:
    gen = LS3DCGGenerator()
    if args.ls3dcg_ckpt:
        sd = torch.load(args.ls3dcg_ckpt, map_location="cpu", weights_only=True)
        gen.load_state_dict(sd["state"]["models"]["gen"])
    else:
        print("NOTE: no --ls3dcg_ckpt; using random weights")
        init_weights_(gen, torch.Generator().manual_seed(args.seed))
    norm_stats = None
    if args.norm_stats:
        arr = np.load(args.norm_stats, allow_pickle=True)
        norm_stats = (arr[0], arr[1])
    return infer_on_audio(gen.to(args.device), args.audio_file, num_samples=args.num_sample,
                          stand=args.stand, norm_stats=norm_stats)


def _stream(pipe: Pipeline, args) -> np.ndarray:
    if args.only_face or args.continuity or args.num_sample != 1:
        raise SystemExit("--streaming generates one full-body stream; it is incompatible "
                         "with --only_face/--continuity/--num_sample>1")
    sess = StreamingSession(pipe, speaker=args.id, stand=args.stand, seed=args.seed)
    wav, sr = audio_ops.load_wav(args.audio_file)
    if sr != 16000:
        wav = audio_ops.resample(torch.as_tensor(wav), sr, 16000).numpy()
    blocks = []
    for i in range(0, len(wav), STREAM_FEED):
        out = sess.feed(wav[i:i + STREAM_FEED])
        if out is not None:
            blocks.append(out)
    tail = sess.finish()
    if tail is not None:
        blocks.append(tail)
    return np.concatenate(blocks)[None]


def main(argv=None) -> np.ndarray:
    """Run the demo; returns the (S, T, 265) motion it saved."""
    args = parse_args(argv)
    if args.model == "ls3dcg":
        motion = _ls3dcg(args)
    else:
        if args.face_ckpt or args.body_ckpt:
            pipe = Pipeline.from_torch_checkpoints(args.face_ckpt, args.body_ckpt,
                                                   args.vq_ckpt, device=args.device)
        else:
            print("NOTE: no checkpoints given; using random weights")
            pipe = Pipeline.create(args.seed, device=args.device)
        if args.norm_stats:
            pipe = pipe.with_norm_stats(args.norm_stats)
        if args.face_f32:
            pipe = pipe.with_face_dtype(torch.float32)
        if args.streaming:
            motion = _stream(pipe, args)
        else:
            motion = pipe.generate(args.audio_file, speaker=args.id,
                                   num_samples=args.num_sample, only_face=args.only_face,
                                   stand=args.stand, continuity=args.continuity,
                                   seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.audio_file))[0]
    out = os.path.join(args.out_dir, stem + ".npy")
    np.save(out, motion.reshape(-1, motion.shape[-1]))
    print(f"saved motion {motion.shape} -> {out}")
    if args.render:
        from talkshow_torch.render import render_motion_video
        render_motion_video(motion, args.audio_file, os.path.join(args.out_dir, stem + ".mp4"),
                            smplx_npz=args.smplx_npz, mode=args.render_mode,
                            device=args.device)
    return motion


if __name__ == "__main__":
    main()

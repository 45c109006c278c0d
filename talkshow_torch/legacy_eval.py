"""Legacy 2D-keypoint evaluation over the Freeform `pose_dataset/` layout
(the port of scripts/legacy_eval.py; host-only, over `eval/legacy2d.py`).

One CLI covering the reference's four standalone scripts
(evaluation/diversity_LVD.py, peak_velocity.py, mode_transition.py,
get_quality_samples.py): walk `<root>/test_audios/<speaker>/*.wav`, load
OpenPose GT keypoints for each clip, load `<wav>_<post_fix>.json`
predictions, and compute the requested metric.

    python -m talkshow_torch.legacy_eval --mode diversity_lvd --speaker oliver \
        --root pose_dataset/videos [--post_fix base] [--split val]

Modes:
  diversity_lvd    mean LVD over hand points    (diversity_LVD.py:24-62)
  peak_velocity    GT/pred peak-velocity consistency stats + .npy dumps
                   (peak_velocity.py:24-63; consistency fn re-derived —
                   the reference's is undefined, see eval/legacy2d.py)
  mode_transition  precision/recall/accuracy of move/hold transitions
                   (mode_transition.py:26-60; seq fn re-derived likewise)
  quality_samples  concatenate GT + pred valid-point tracks to
                   `<out_dir>/quality_samples_<speaker>.json`
                   (get_quality_samples.py:24-62)
"""
import argparse
import json
import os
from glob import glob

import numpy as np

from talkshow_torch.eval import legacy2d as l2d


def main(argv=None) -> dict:
    """Run one mode; returns the JSON object it printed."""
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.legacy_eval")
    p.add_argument("--mode", required=True,
                   choices=["diversity_lvd", "peak_velocity",
                            "mode_transition", "quality_samples"])
    p.add_argument("--speaker", required=True)
    p.add_argument("--root", default="pose_dataset/videos")
    p.add_argument("--post_fix", nargs="+", default=["base"])
    p.add_argument("--split", default="val")
    p.add_argument("--out_dir", default="experiments")
    args = p.parse_args(argv)

    wavs = sorted(glob(os.path.join(args.root, "test_audios", args.speaker,
                                    "*.wav")))
    if not wavs:
        raise FileNotFoundError(
            f"no wavs under {args.root}/test_audios/{args.speaker}")

    lvd_vals, gt_cons, pred_cons = [], [], []
    prec, rec, acc = [], [], []
    quality = {"gt": [], **{pf: [] for pf in args.post_fix}}

    for wav in wavs:
        clip_dir = l2d.clip_path_for_wav(wav, args.speaker, args.split,
                                         args.root)
        _, gt_poses, _ = l2d.load_openpose_clip(clip_dir)
        gt_poses = gt_poses[None]                       # (1, T, K*2)
        if args.mode == "quality_samples":
            quality["gt"].append(l2d.valid_points(gt_poses))
        for pf in args.post_fix:
            pred_path = os.path.splitext(wav)[0] + "_" + pf + ".json"
            with open(pred_path) as f:
                pred = np.asarray(json.load(f), np.float64)  # (B, T, 108)
            pred = l2d.cvt25(pred, gt_poses)
            if args.mode == "diversity_lvd":
                g = l2d.hand_points(gt_poses)[0]
                g = g.reshape(g.shape[0], -1, 2)
                for s in l2d.hand_points(pred):
                    lvd_vals.append(
                        l2d.lvd_2d(g, s.reshape(s.shape[0], -1, 2)))
            elif args.mode == "peak_velocity":
                gp = l2d.peak_velocity(l2d.hand_points(gt_poses)[0]
                                       .reshape(gt_poses.shape[1], -1, 2))
                pp = l2d.peak_velocity(l2d.hand_points(pred)[0]
                                       .reshape(pred.shape[1], -1, 2))
                gt_cons.append(l2d.velocity_consistency(gp, pp))
                pred_cons.append(l2d.velocity_consistency(pp, gp))
            elif args.mode == "mode_transition":
                if gt_poses.shape[1] < 50:              # ref skip, :30-31
                    continue
                g = l2d.mode_transition_seq(l2d.valid_points(gt_poses))
                s = l2d.mode_transition_seq(l2d.valid_points(pred))
                n = min(g.shape[1], s.shape[1])
                out = l2d.mode_transition_consistency(s[:, :n], g[:, :n])
                prec.append(out[0]); rec.append(out[1]); acc.append(out[2])
            else:
                quality[pf].append(l2d.valid_points(pred)[0:1])

    if args.mode == "diversity_lvd":
        result = {"LVD": float(np.mean(lvd_vals)), "n": len(lvd_vals)}
    elif args.mode == "peak_velocity":
        gt_cons = np.concatenate(gt_cons) if gt_cons else np.zeros(0)
        pred_cons = np.concatenate(pred_cons) if pred_cons else np.zeros(0)
        os.makedirs(args.out_dir, exist_ok=True)
        np.save(os.path.join(args.out_dir, f"{args.speaker}_gt.npy"),
                gt_cons)
        np.save(os.path.join(args.out_dir, f"{args.speaker}_pred.npy"),
                pred_cons)
        result = {"gt_consistency_mean": float(gt_cons.mean()),
                  "gt_consistency_std": float(gt_cons.std()),
                  "pred_consistency_mean": float(pred_cons.mean()),
                  "pred_consistency_std": float(pred_cons.std())}
    elif args.mode == "mode_transition":
        result = {"precision": float(np.mean(prec)), "recall": float(np.mean(rec)),
                  "accuracy": float(np.mean(acc)), "n": len(acc)}
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        out = {k: np.concatenate(v, axis=1).tolist()
               for k, v in quality.items() if v}
        path = os.path.join(args.out_dir,
                            f"quality_samples_{args.speaker}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        result = {"saved": path,
                  "keys": {k: np.asarray(v).shape[1] for k, v in out.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

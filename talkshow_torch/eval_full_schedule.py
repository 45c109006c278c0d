"""The eval battery after a full-schedule run (port of
scripts/eval_full_schedule.py).

Loads the checkpoints `python -m talkshow_torch.full_schedule` trained
(body-VQ, body-pixel prior, face, body-AE and, when trained, LS3DCG) at the
widths the port's train CLI builds, and on the held-out test split computes
the reference's metric suite through `eval/runners.py`:

  * the VQ round trip's L1 ("capacity"; K4 twice a clip on the card);
  * FGD with the self-trained body-AE, feature MAE, L2 and diversity for the
    trained pipeline and for a random-init prior and audio encoder on the
    same frozen VQs (K1 once a clip), and their paired gaps (the same seed
    and clip walk in both arms, `eval/fgd.paired_fgd_gap`,
    `eval/metrics.paired_clip_gap`);
  * the SMPL-X metrics (joint LVD, beat consistency, face-vertex LVD) when
    --smplx_npz names a rig;
  * jaw L1 / expression MSE of the trained face against a random-init one
    (K3 + K2 once a clip on f32 tables);
  * LS3DCG's per-part L1 / MSE and FGD against a random init, when its
    stage ran;
plus a training summary read from each stage's history.json.  The output
JSON has the JAX script's keys; the bootstrap draws are dropped after the
paired gaps are taken.

    python -m talkshow_torch.eval_full_schedule --data_root experiments/r04_data \\
        --run_root experiments/r04_schedule --last_epoch 99 --out EVAL_r05.json
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from talkshow_torch.config import Config, body_pixel_config
from talkshow_torch.data.dataset import ShowDataset
from talkshow_torch.eval.fgd import paired_fgd_gap
from talkshow_torch.eval.metrics import paired_clip_gap
from talkshow_torch.eval.runners import eval_body, eval_face, eval_ls3dcg, eval_vq_capacity
from talkshow_torch.full_schedule import CURVE_KEYS
from talkshow_torch.models.body import BodyModels
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.ls3dcg import LS3DCGGenerator
from talkshow_torch.models.pixelcnn import GatedPixelCNN
from talkshow_torch.models.vqvae import AE, VQVAE, AudioEncoder
from talkshow_torch.ops.pose import BODY_DIM, CONV_DIM, HAND_DIM
from talkshow_torch.ops.smplx_lbs import load_smplx_npz
from talkshow_torch.ops.vq import VQState
from talkshow_torch.train.steps import make_face_step

SPEAKERS = ["oliver", "chemistry", "seth", "conan"]


def summarize_history(run_root: str) -> dict:
    """Per trained stage: epochs, first / last / min of its headline loss,
    whether it improved, the last-quarter over first-quarter mean, the
    final non-finite skip count and the wall seconds."""
    out = {}
    for stage, key in CURVE_KEYS.items():
        path = os.path.join(run_root, stage, "history.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            hist = json.load(f)
        ys = [e[key] for e in hist if key in e]
        if not ys:   # partially-written / mismatched run: skip, don't crash
            continue
        secs = [e.get("epoch_seconds", 0.0) for e in hist]
        skips = [e.get("nonfinite_skips", 0.0) for e in hist]
        n = len(ys)
        q = max(1, n // 4)
        out[stage] = {
            "epochs": n,
            "first": round(ys[0], 5), "last": round(ys[-1], 5),
            "min": round(min(ys), 5),
            "improved": bool(ys[-1] < ys[0]),
            # convergence: last-quartile mean vs first-quartile mean
            "late_over_early": round((sum(ys[-q:]) / q) / max(1e-9, sum(ys[:q]) / q), 4),
            "nonfinite_skips_final": int(skips[-1]) if skips else 0,
            "total_wall_s": round(sum(secs), 1),
            "mean_epoch_s": round(sum(secs) / max(1, n), 2),
        }
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m talkshow_torch.eval_full_schedule")
    ap.add_argument("--data_root", default="experiments/r04_data")
    ap.add_argument("--run_root", default="experiments/r04_schedule")
    ap.add_argument("--last_epoch", type=int, default=99)
    ap.add_argument("--num_samples", type=int, default=4)
    ap.add_argument("--smplx_npz", default="experiments/smplx_synthetic.npz",
                    help="SMPL-X model npz enabling the joint/vertex-space metrics "
                         "(LVD, BC, face LVD); '' disables")
    ap.add_argument("--cache_tag", default="r05",
                    help="eval-split pickle-cache tag (bump when the test split grows so "
                         "stale caches are never reused)")
    ap.add_argument("--rep6d_json", default="",
                    help="rep6d probe json to inline (default: docs/<tag>_schedule/rep6d.json "
                         "next to --out)")
    ap.add_argument("--out", default="EVAL_r05.json")
    ap.add_argument("--config_dir", default=None,
                    help="the reference's config/*.json (body_pixel.json is read); default: "
                         "Config's defaults")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _restore(run_root: str, stage: str, last_epoch: int) -> dict:
    """The train state of <run_root>/<stage>/ckpt-<last_epoch>.pt, or of
    the newest checkpoint there."""
    path = os.path.join(run_root, stage, f"ckpt-{last_epoch}.pt")
    if not os.path.isfile(path):
        d = os.path.join(run_root, stage)
        cands = [f for f in os.listdir(d) if f.startswith("ckpt-") and f.endswith(".pt")]
        # numeric sort: lexicographic puts ckpt-9 after ckpt-10..89
        path = os.path.join(d, max(cands, key=lambda f: int(f[5:-3])))
    return torch.load(path, map_location="cpu", weights_only=True)["state"]


def _baseline(gen: torch.Generator, *models):
    """Random-init models, drawn from `gen` in order."""
    for m in models:
        init_weights_(m, gen)
    return models


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (Config.from_reference_json(os.path.join(args.config_dir, "body_pixel.json"))
           if args.config_dir else body_pixel_config())
    W, mc = cfg.data.pose.generate_length, cfg.model

    smplx_model = None
    if args.smplx_npz and os.path.exists(args.smplx_npz):
        smplx_model = load_smplx_npz(args.smplx_npz, device=dev)
        print(f"SMPL-X metrics ON ({args.smplx_npz}: {smplx_model.v_template.shape[0]} verts)")
    else:
        print("SMPL-X metrics OFF (no npz)")

    def restore(stage):
        return _restore(args.run_root, stage, args.last_epoch)

    # ---- stage models at the widths the train CLI builds ----
    st1 = restore("body_vq")
    vq_body = VQVAE(BODY_DIM, mc.vq_embedding_dim, mc.vq_num_hiddens)
    vq_hand = VQVAE(HAND_DIM, mc.vq_embedding_dim, mc.vq_num_hiddens)
    vq_body.load_state_dict(st1["models"]["body"])
    vq_hand.load_state_dict(st1["models"]["hand"])
    vq_body, vq_hand = vq_body.to(dev).eval(), vq_hand.to(dev).eval()
    states = {k: VQState(**s).to(dev) for k, s in st1["vq"].items()}

    def prior_and_audio():
        return (GatedPixelCNN(input_dim=mc.code_num, dim=mc.pixelcnn_dim,
                              n_layers=mc.pixelcnn_layers, n_classes=mc.num_speakers,
                              bh_model=mc.bh_model),
                AudioEncoder(num_hiddens=256))

    def body_models(prior, audio):
        return BodyModels(vq_body, vq_hand, states["body"], states["hand"],
                          audio.to(dev).eval(), prior.to(dev).eval())

    st2 = restore("body_pixel")
    prior, audio = prior_and_audio()
    prior.load_state_dict(st2["models"]["prior"])
    audio.load_state_dict(st2["models"]["audio"])
    trained = body_models(prior, audio)
    baseline = body_models(*_baseline(torch.Generator().manual_seed(123), *prior_and_audio()))

    ae = AE(CONV_DIM, num_hiddens=mc.vq_num_hiddens)
    ae.load_state_dict(restore("body_ae")["model"])
    ae = ae.to(dev).eval()

    face = FaceGenerator()
    face.load_state_dict(restore("face")["face"])
    face = face.to(dev).eval()
    face_random = make_face_step(FaceGenerator())[0](torch.Generator().manual_seed(7), dev) \
        .face.eval()

    # ---- datasets (test split; MFCC for the body, raw 16 kHz for the face) ----
    def split(feat):
        return ShowDataset.from_root(
            args.data_root, SPEAKERS, "test", feat=feat,
            cache_pkl=os.path.join(args.data_root, f"test_eval_{args.cache_tag}_{feat}.pkl"),
            generate_length=W, device=args.device)

    ds, ds_raw = split("mfcc"), split("raw")
    print(f"test clips: {len(ds.clips)}")

    results = {"train_summary": summarize_history(args.run_root),
               "num_test_clips": len(ds.clips),
               "num_samples": args.num_samples,
               "smplx": bool(smplx_model is not None)}
    results["vq_capacity"] = eval_vq_capacity(vq_body, vq_hand, states, ds)
    print("capacity:", results["vq_capacity"], flush=True)

    results["body_trained"] = eval_body(trained, ae, ds, num_samples=args.num_samples,
                                        smplx_model=smplx_model)
    results["body_random_prior"] = eval_body(baseline, ae, ds, num_samples=args.num_samples,
                                             smplx_model=smplx_model)
    results["fgd_trained_beats_random"] = bool(
        results["body_trained"]["fgd"] < results["body_random_prior"]["fgd"])
    if "fgd_ci" in results["body_trained"]:
        # paired gaps: same seed + clip walk in both arms, so the shared
        # which-clips variance cancels
        gaps = {"fgd": paired_fgd_gap(results["body_trained"]["fgd_ci"],
                                      results["body_random_prior"]["fgd_ci"])}
        for key in ("l2", "lvd"):
            a = results["body_trained"]["per_clip"].get(key)
            b = results["body_random_prior"]["per_clip"].get(key)
            if a and b:
                gaps[key] = paired_clip_gap(a, b)
        results["body_gap_trained_minus_random"] = gaps
        print("body gaps (trained - random):", gaps, flush=True)

    results["face_trained"] = eval_face(face, ds_raw, smplx_model)
    results["face_random_init"] = eval_face(face_random, ds_raw, smplx_model)
    results["face_trained_beats_random"] = bool(
        results["face_trained"]["jaw_l1"] < results["face_random_init"]["jaw_l1"])
    if "per_clip" in results["face_trained"]:
        results["face_gap_trained_minus_random"] = {"jaw_l1": paired_clip_gap(
            results["face_trained"]["per_clip"]["jaw_l1"],
            results["face_random_init"]["per_clip"]["jaw_l1"])}

    # ---- the LS3DCG baseline, when its schedule stage ran ----
    if os.path.isdir(os.path.join(args.run_root, "ls3dcg")):
        gen = LS3DCGGenerator()
        gen.load_state_dict(restore("ls3dcg")["models"]["gen"])
        results["ls3dcg_trained"] = eval_ls3dcg(gen.to(dev), ae, ds)
        print("ls3dcg trained:", results["ls3dcg_trained"], flush=True)
        gen_r, = _baseline(torch.Generator().manual_seed(21), LS3DCGGenerator())
        results["ls3dcg_random_init"] = eval_ls3dcg(gen_r.to(dev), ae, ds)
        results["ls3dcg_trained_beats_random"] = bool(
            results["ls3dcg_trained"]["body_l1"] < results["ls3dcg_random_init"]["body_l1"]
            and results["ls3dcg_trained"]["fgd"] < results["ls3dcg_random_init"]["fgd"])
        if "fgd_ci" in results["ls3dcg_trained"]:
            results["ls3dcg_gap_trained_minus_random"] = {
                "fgd": paired_fgd_gap(results["ls3dcg_trained"]["fgd_ci"],
                                      results["ls3dcg_random_init"]["fgd_ci"]),
                "body_l1": paired_clip_gap(results["ls3dcg_trained"]["per_clip"]["body_l1"],
                                           results["ls3dcg_random_init"]["per_clip"]["body_l1"])}

    # ---- the rep6d probe's results, when present (EVAL_<tag>.json ->
    # docs/<tag>_schedule/rep6d.json beside it) ----
    out_stem = os.path.splitext(os.path.basename(args.out))[0]
    tag = out_stem[len("EVAL_"):] if out_stem.startswith("EVAL_") else out_stem
    rep6d_path = args.rep6d_json or os.path.join(
        os.path.dirname(os.path.abspath(args.out)), "docs", f"{tag}_schedule", "rep6d.json")
    if os.path.exists(rep6d_path):
        with open(rep6d_path) as f:
            results["rep6d"] = json.load(f)

    # the raw bootstrap draws served the paired gaps; keep summary stats
    for sec in results.values():
        if isinstance(sec, dict) and isinstance(sec.get("fgd_ci"), dict):
            sec["fgd_ci"].pop("draws", None)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()

"""A structured, learnable SHOW-shaped dataset written to disk (the port's
copy of the tree writer of scripts/make_synthetic_show.py, numpy only; for
the same arguments it writes the same bytes).

Real pkl + wav files in the SHOW layout
(`root/<speaker>/<vid>/<split>/<clip>/clip.{pkl,wav}`, the layout
`data/dataset.ShowDataset.from_root` walks), with cross-modal structure a
training run can learn, so a trained pipeline beats a random-init one:

  * audio is a syllable train: ~4 Hz voiced bursts (speaker-specific f0
    harmonics + aspiration noise) with a smooth RMS envelope;
  * body and hand motion follow a per-speaker Markov chain over K gesture
    archetypes (offset + per-channel oscillation), switching at
    syllable-group onsets with smooth 12-frame transitions;
  * the jaw opens with the audio envelope and the leading expression
    channels follow it (what the face stage must learn);
  * eyes blink sparsely; the global orientation drifts slowly.

    python -m talkshow_torch.data.synthetic_show --root experiments/r04_data \
        --clips-per-speaker 8 --train-seconds 29

`write_show_tree` writes a whole tree and `append_test_clips` grows its test
split; `python -m talkshow_torch.full_schedule` calls the former when its
--data_root does not exist.
"""
from __future__ import annotations

import argparse
import os
import pickle
import wave

import numpy as np

SPEAKERS = ("oliver", "chemistry", "seth", "conan")
FPS = 30
SR = 16000  # native featurizer resamples 16k->22k for MFCC in C++


def _smooth(x: np.ndarray, win: int) -> np.ndarray:
    """Hann-window moving average along axis 0 (keeps length)."""
    if win <= 1:
        return x
    k = np.hanning(win).astype(np.float32)
    k /= k.sum()
    pad = win // 2
    xp = np.pad(x, [(pad, win - 1 - pad)] + [(0, 0)] * (x.ndim - 1), "edge")
    return np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 0, xp)


def _syllable_envelope(rng, n_samples: int) -> np.ndarray:
    """0..1 amplitude envelope: voiced bursts ~0.1-0.3 s, gaps 0.05-0.2 s."""
    env = np.zeros(n_samples, np.float32)
    onsets = []
    i = 0
    while i < n_samples:
        gap = int(rng.uniform(0.05, 0.20) * SR)
        dur = int(rng.uniform(0.10, 0.30) * SR)
        i += gap
        if i >= n_samples:
            break
        amp = rng.uniform(0.5, 1.0)
        env[i:i + dur] = amp
        onsets.append(i)
        i += dur
    k = np.hanning(int(0.03 * SR) | 1).astype(np.float32)
    env = np.convolve(env, k / k.sum(), "same")
    return env, np.asarray(onsets)


def _voiced_wave(rng, n_samples: int, f0: float, env: np.ndarray) -> np.ndarray:
    t = np.arange(n_samples, dtype=np.float64) / SR
    vib = 1.0 + 0.02 * np.sin(2 * np.pi * 5.3 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0 * vib) / SR
    wave_v = np.zeros(n_samples)
    for k in range(1, 6):
        wave_v += rng.uniform(0.3, 1.0) / k * np.sin(k * phase + rng.uniform(0, 6.28))
    noise = rng.standard_normal(n_samples)
    x = env * (0.75 * wave_v / np.abs(wave_v).max() + 0.15 * noise) \
        + 0.01 * rng.standard_normal(n_samples)
    x = 0.8 * x / max(1e-6, np.abs(x).max())
    return x.astype(np.float32)


def synth_clip(rng: np.random.Generator, sp_idx: int, frames: int):
    """One clip: returns (pkl_dict, waveform float32 @16 kHz)."""
    n = frames * SR // FPS
    env, onsets = _syllable_envelope(rng, n)
    f0 = 105.0 + 28.0 * sp_idx
    wav_x = _voiced_wave(rng, n, f0, env)

    # per-frame envelope (RMS over each frame's samples)
    spf = SR // FPS
    env30 = np.sqrt(_smooth((env[: frames * spf] ** 2).reshape(frames, spf)
                            .mean(-1, keepdims=True), 5))[:, 0]

    # ---- gesture archetypes: per-speaker, stable across clips ----
    arng = np.random.default_rng(1234 + sp_idx)
    K = 6
    base_body = 0.15 * arng.standard_normal(63).astype(np.float32)
    arch_off = 0.25 * arng.standard_normal((K, 63)).astype(np.float32)
    arch_amp = (0.08 + 0.10 * arng.random((K, 63))).astype(np.float32) \
        * (arng.random((K, 63)) < 0.35)
    arch_freq = arng.uniform(0.4, 1.8, (K,)).astype(np.float32)
    arch_phase = arng.uniform(0, 6.28, (K, 63)).astype(np.float32)
    hand_off = 0.30 * arng.standard_normal((K, 24)).astype(np.float32)

    # state sequence: switch at syllable-group onsets every ~1-2.5 s
    state = np.zeros(frames, np.int32)
    cur = int(rng.integers(K))
    next_switch = 0.0
    onset_f = set((onsets // spf).tolist())
    for f in range(frames):
        if f >= next_switch and (f in onset_f or f == 0):
            cur = int(rng.integers(K))
            next_switch = f + rng.uniform(1.0, 2.5) * FPS
        state[f] = cur
    onehot = np.eye(K, dtype=np.float32)[state]            # (T, K)
    w = _smooth(onehot, 12)                                 # soft transitions
    w /= w.sum(-1, keepdims=True)

    t30 = np.arange(frames, dtype=np.float32) / FPS
    osc = np.sin(2 * np.pi * arch_freq[:, None, None] * t30[None, :, None]
                 + arch_phase[:, None, :])                  # (K, T, 63)
    body = base_body + np.einsum("tk,kc->tc", w, arch_off) \
        + np.einsum("tk,ktc->tc", w, arch_amp[:, None, :] * osc) \
        + _smooth(0.04 * rng.standard_normal((frames, 63)).astype(np.float32), 9)

    hands = np.einsum("tk,kc->tc", w, hand_off) \
        + _smooth(0.08 * rng.standard_normal((frames, 24)).astype(np.float32), 9)

    jaw = np.zeros((frames, 3), np.float32)
    jaw[:, 0] = 0.05 + 0.45 * env30 \
        + _smooth(0.01 * rng.standard_normal(frames).astype(np.float32), 5)
    jaw[:, 1:] = _smooth(0.01 * rng.standard_normal((frames, 2)).astype(np.float32), 5)

    # sparse blinks: ~0.25 s closures every 2-5 s
    eye = np.zeros((frames, 3), np.float32)
    f = int(rng.uniform(0, 60))
    while f < frames - 8:
        eye[f:f + 7, 0] = 0.6 * np.hanning(7)
        f += int(rng.uniform(2.0, 5.0) * FPS)
    leye, reye = eye, eye.copy()

    orient = np.zeros((frames, 3), np.float32)
    orient[:, 1] = 0.1 * np.sin(2 * np.pi * 0.07 * t30 + rng.uniform(0, 6.28))
    orient[:, 0] = 0.05 * np.sin(2 * np.pi * 0.05 * t30 + rng.uniform(0, 6.28))

    expr = np.zeros((frames, 100), np.float32)
    exp_dirs = np.random.default_rng(99 + sp_idx).standard_normal((10,)).astype(np.float32)
    expr[:, :10] = 0.8 * env30[:, None] * exp_dirs + _smooth(
        0.05 * rng.standard_normal((frames, 10)).astype(np.float32), 9)
    expr[:, 10:] = _smooth(0.08 * rng.standard_normal((frames, 90)).astype(np.float32), 15)

    betas = (0.5 * np.random.default_rng(7 + sp_idx).standard_normal(300)
             ).astype(np.float32)
    pkl = {
        "jaw_pose": jaw, "leye_pose": leye, "reye_pose": reye,
        "global_orient": orient.reshape(frames, 1, 3),
        "body_pose_axis": body.astype(np.float32),
        "left_hand_pose": hands[:, :12].astype(np.float32),
        "right_hand_pose": hands[:, 12:].astype(np.float32),
        "expression": expr, "betas": betas,
    }
    return pkl, wav_x


def write_clip(cdir: str, pkl: dict, wav_x: np.ndarray):
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "clip.pkl"), "wb") as f:
        pickle.dump(pkl, f)
    pcm = (np.clip(wav_x, -1, 1) * 32767).astype(np.int16)
    with wave.open(os.path.join(cdir, "clip.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def write_show_tree(root: str, clips_per_speaker: int = 8, train_seconds: float = 29.0,
                    eval_seconds: float = 20.0, seed: int = 0) -> float:
    """Per speaker `clips_per_speaker` train clips of train_seconds +- 2 s
    and one val and one test clip of eval_seconds; returns the minutes of
    motion written."""
    rng = np.random.default_rng(seed)
    total = 0.0
    for si, sp in enumerate(SPEAKERS):
        for ci in range(clips_per_speaker):
            # vary lengths +-2 s so face bucketing has real work to do
            frames = int((train_seconds + rng.uniform(-2, 2)) * FPS)
            pkl, wav_x = synth_clip(rng, si, frames)
            write_clip(os.path.join(root, sp, "vid1", "train", f"clip{ci:02d}"), pkl, wav_x)
            total += frames / FPS
        for split in ("val", "test"):
            frames = int(eval_seconds * FPS)
            pkl, wav_x = synth_clip(rng, si, frames)
            write_clip(os.path.join(root, sp, "vid1", split, "clip00"), pkl, wav_x)
            total += frames / FPS
    return total / 60


def append_test_clips(root: str, count: int, eval_seconds: float = 20.0, seed: int = 0) -> None:
    """Append `count` test clips per speaker to an existing tree (train
    data untouched), each seeded by (seed + 20000, speaker, absolute clip
    index), so a second append continues with fresh clips."""
    for si, sp in enumerate(SPEAKERS):
        tdir = os.path.join(root, sp, "vid1", "test")
        have = len([d for d in os.listdir(tdir)
                    if d.startswith("clip")]) if os.path.isdir(tdir) else 0
        for ci in range(have, have + count):
            rng = np.random.default_rng([seed + 20_000, si, ci])
            pkl, wav_x = synth_clip(rng, si, int(eval_seconds * FPS))
            write_clip(os.path.join(tdir, f"clip{ci:02d}"), pkl, wav_x)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m talkshow_torch.data.synthetic_show")
    p.add_argument("--root", default="experiments/r04_data")
    p.add_argument("--clips-per-speaker", type=int, default=8)
    p.add_argument("--train-seconds", type=float, default=29.0)
    p.add_argument("--eval-seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only-extra-test", type=int, default=0, metavar="N",
                   help="append N extra TEST clips per speaker to an existing tree")
    args = p.parse_args(argv)
    if args.only_extra_test:
        append_test_clips(args.root, args.only_extra_test, args.eval_seconds, args.seed)
        print(f"appended {args.only_extra_test} test clips per speaker under {args.root}")
        return
    minutes = write_show_tree(args.root, args.clips_per_speaker, args.train_seconds,
                              args.eval_seconds, args.seed)
    print(f"wrote {args.root}: {len(SPEAKERS)}x{args.clips_per_speaker} train clips "
          f"(+val/test), {minutes:.1f} min of motion total")


if __name__ == "__main__":
    main()

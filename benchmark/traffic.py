"""The one traffic generator: synthetic speech clips and a closed-loop
request stream, both drawn from the seed and shaped by the workload file.

Workload keys read here:

- ``clip_seconds``: the clip lengths; ``variants``: distinct clips of each
  length; ``speakers``: the speaker ids requests name;
- ``noise_given_per_block``: how many requests of each block carry a gumbel
  block the benchmark draws (and the check replays) instead of the
  program's own Philox noise.

A block holds every (length, variant) pair once, in an order drawn from the
seed, each with a speaker drawn from the seed; the requests that carry
given noise are one per length, up to ``noise_given_per_block``.  So every
seed sends the same sizes in the same proportions, in another order."""
from __future__ import annotations

import os
import wave
from dataclasses import dataclass

import numpy as np

RATE = 16000


@dataclass(frozen=True)
class Clip:
    path: str
    seconds: float
    samples: int


@dataclass(frozen=True)
class Request:
    index: int
    clip: Clip
    speaker: int
    seed: int            # the program's sampling seed
    noise_seed: int | None   # set: the benchmark draws the gumbel block


def speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Speech-like audio at 16 kHz: voiced syllables of 80-300 ms on a
    wandering pitch of 90-260 Hz with 8 harmonics under three formant
    bumps, unvoiced noise bursts and short pauses; peak 0.6."""
    n = int(round(seconds * RATE))
    out = np.zeros(n, np.float64)
    pos = 0
    while pos < n:
        kind = rng.random()
        dur = int(rng.uniform(0.08, 0.30) * RATE)
        dur = min(dur, n - pos)
        t = np.arange(dur) / RATE
        env = np.sin(np.pi * np.arange(dur) / max(dur, 1)) ** 2
        if kind < 0.7:
            f0 = rng.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(1, 5) * t))
            phase = 2 * np.pi * np.cumsum(f0) / RATE
            formants = rng.uniform([300, 900, 2200], [900, 2200, 3200])
            sig = np.zeros(dur)
            for h in range(1, 9):
                fh = h * f0.mean()
                gain = sum(np.exp(-((fh - f) / 250.0) ** 2) for f in formants) + 0.05
                sig += gain / h * np.sin(h * phase)
            out[pos:pos + dur] = sig * env
        elif kind < 0.85:
            out[pos:pos + dur] = 0.3 * rng.standard_normal(dur) * env
        pos += dur
    out += 0.003 * rng.standard_normal(n)
    return (0.6 * out / max(np.abs(out).max(), 1e-9)).astype(np.float32)


def write_wav(path: str, x: np.ndarray) -> None:
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(pcm.tobytes())


def make_clips(workload: dict, seed: int, directory: str) -> list[Clip]:
    """Write every (length, variant) clip of the workload under `directory`
    (16-bit PCM mono wav at 16 kHz); returns them in (length, variant) order."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    clips = []
    for sec in workload["clip_seconds"]:
        for v in range(workload["variants"]):
            path = os.path.join(directory, f"clip_{sec:g}s_{v}.wav")
            x = speech(sec, rng)
            write_wav(path, x)
            clips.append(Clip(path, float(sec), len(x)))
    return clips


def requests(workload: dict, clips: list[Clip], seed: int):
    """The endless request stream of a closed loop: blocks of every clip
    once, in an order drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    speakers = list(workload["speakers"])
    lengths = list(workload["clip_seconds"])
    v = workload["variants"]
    given = workload.get("noise_given_per_block", 0)
    index = 0
    while True:
        order = rng.permutation(len(clips))
        noisy_len = set(rng.permutation(len(lengths))[:given].tolist())
        noisy = {li * v + int(rng.integers(v)) for li in noisy_len}
        spk = rng.choice(speakers, size=len(clips))
        seeds = rng.integers(0, 2 ** 62, size=(len(clips), 2))
        for k in order:
            k = int(k)
            yield Request(index, clips[k], int(spk[k]), int(seeds[k, 0]),
                          int(seeds[k, 1]) if k in noisy else None)
            index += 1

"""Streaming generation: audio chunks in, motion frames out (port of
talkshow_tpu/streaming.py:58-188).

A sliding window over the token grid: each step generates `chunk_rows`
new token rows conditioned on the last `context_rows` rows (a
teacher-forced prefix of the AR decode) and the window's audio.  After a
short ramp-up the window's shape is fixed, so a stream of any length meets
at most ceil(context_rows / chunk_rows) + 1 window shapes, and the work and
the state of a step stay bounded: the audio ring and the token history are
trimmed to what the next window can reach.

Each step runs the unmasked face stage on the window's audio (on the card
K3 + K2 at B = 1; its attention sees the whole window) and emits only the
new frames, then the window's MFCC and one AR decode (K1 at B = 1 with the
history as its prefix), then the VQ decoders.

Usage:
    sess = StreamingSession(pipe, speaker=0)
    for wav_chunk in audio_source:          # 16 kHz float32
        motion = sess.feed(wav_chunk)       # (n * chunk_rows*4, 265) or None
    motion = sess.finish()                  # flush the remainder
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from talkshow_torch.models.body import generate_conv_poses
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.serving import group_seed

_SR = 16000
_FPS = 30


def samples_for(frames: int) -> int:
    """Smallest sample count whose frame count (len * FPS // SR, the
    wav2vec convention) is exactly `frames`: ceil(frames * SR / FPS)."""
    return -(-frames * _SR // _FPS)


@dataclass
class StreamingSession:
    """Chunked speech -> SMPL-X motion with bounded window shapes and state.

    noise: for parity with the JAX session, a callable
    (rows_done, rows) -> gumbel block (rows, 2, 1, K) for the step whose
    window starts its new rows at token row `rows_done`; None draws from
    torch.Generator(group_seed(seed, rows_done)) (Philox on the card)."""
    pipe: object
    speaker: int = 0
    chunk_rows: int = 8        # token rows emitted per step (x4 frames)
    context_rows: int = 16     # teacher-forced history rows
    stand: bool = False
    seed: int = 0
    noise: Callable | None = None
    #: tail of the audio stream: absolute sample index of _wav[0] is
    #: _wav_start; older samples are dropped
    _wav: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    _wav_start: int = 0
    _tokens: np.ndarray | None = None      # last <= context_rows rows
    _rows_done: int = 0
    _emitted_frames: int = 0
    _finished: bool = False

    @property
    def _chunk_frames(self) -> int:
        return self.chunk_rows * 4

    def feed(self, wav16: np.ndarray):
        """Append audio; returns every newly completed (chunk_rows*4, 265)
        block concatenated, or None if no chunk has filled yet."""
        if self._finished:
            raise RuntimeError("StreamingSession.feed() after finish(): finish() pads the "
                               "ring buffer with zeros, so further audio would misalign "
                               "frame accounting. Start a new session.")
        self._wav = np.concatenate([self._wav, np.asarray(wav16, np.float32).reshape(-1)])
        out = []
        while self._wav_start + len(self._wav) >= samples_for(
                self._emitted_frames + self._chunk_frames):
            out.append(self._step())
        return np.concatenate(out) if out else None

    def finish(self):
        """Zero-pad the tail to a full chunk and emit it (or None if no
        un-emitted frames remain).  Closes the session: a later feed()
        raises."""
        self._finished = True
        total = self._wav_start + len(self._wav)
        rem_frames = total * _FPS // _SR - self._emitted_frames
        if rem_frames <= 0:
            return None
        pad = samples_for(self._emitted_frames + self._chunk_frames) - total
        if pad > 0:
            self._wav = np.concatenate([self._wav, np.zeros(pad, np.float32)])
        return self._step()[:rem_frames]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _step(self) -> np.ndarray:
        pipe = self.pipe
        dev = pipe.device
        # ramp-up: until context_rows of history exist, teacher-force all
        # of it; afterwards the window's shape is fixed
        prefix_rows = min(self._rows_done, self.context_rows)
        rows = prefix_rows + self.chunk_rows
        frames = rows * 4

        end = samples_for(self._emitted_frames + self._chunk_frames)
        n_win = samples_for(frames)
        wav_win = np.zeros(n_win, np.float32)
        lo = max(0, end - n_win)
        seg = self._wav[max(0, lo - self._wav_start):end - self._wav_start]
        wav_win[n_win - len(seg):] = seg
        wav = torch.as_tensor(wav_win).to(dev)

        face = pipe.face_stage(wav[None], torch.zeros((1, pipe.num_classes), device=dev),
                               frames)[0]
        feat = audio_ops.mfcc(audio_ops.resample(wav, 16000, 22000), 22000, fps=_FPS)[:frames]
        prefix = torch.zeros((1, rows, 2), dtype=torch.long, device=dev)
        if prefix_rows:
            prefix[0, :prefix_rows] = torch.as_tensor(self._tokens[-prefix_rows:]).to(dev)
        if self.noise is not None:
            noise = self.noise(self._rows_done, rows).to(dev, torch.float32).contiguous()
            gen = None
        else:
            noise, gen = None, torch.Generator().manual_seed(group_seed(self.seed,
                                                                        self._rows_done))
        sid = torch.full((1,), self.speaker, dtype=torch.long, device=dev)
        conv, tokens = generate_conv_poses(pipe.body, feat[None], sid, generator=gen,
                                           noise=noise, tables=pipe._decode_tables,
                                           prefix_tokens=prefix, prefix_len=prefix_rows)
        face, conv, tokens = face.cpu().numpy(), conv[0].cpu().numpy(), tokens[0].cpu().numpy()
        conv = pipe._denorm_conv(conv)

        new_tok = tokens[prefix_rows:]
        hist = new_tok if self._tokens is None else np.concatenate([self._tokens, new_tok])
        self._tokens = hist[-self.context_rows:]   # bounded history
        self._rows_done += self.chunk_rows

        # drop audio the next window can no longer reach (bounded memory)
        keep_from = max(0, end - samples_for((self.context_rows + self.chunk_rows) * 4))
        if keep_from > self._wav_start:
            self._wav = self._wav[keep_from - self._wav_start:]
            self._wav_start = keep_from

        # emit only the new frames (the tail of the window)
        self._emitted_frames += self._chunk_frames
        return pipe.assemble_full(face[-self._chunk_frames:],
                                  conv[None, -self._chunk_frames:], self.stand)[0]

"""Plain float32 reference of the audio front end: torchaudio's windowed-sinc
resampling (`transforms.Resample` defaults) and TalkSHOW's
`get_mfcc_ta(type='mfcc')`: a 2048-point STFT (periodic Hann, centred,
reflect padding) at hop 734 for 30 fps, power, 256 HTK mels without
normalisation, dB with an 80 dB floor below the clip's peak, and the
orthonormal DCT-II to 64 coefficients.  Tables are built here in float64
and rounded once; `torch.stft` does the framing."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def resample(x: torch.Tensor, orig: int, new: int, width_zeros: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """(T,) -> (ceil(new T / orig),), torchaudio's sinc_interp_hann kernel."""
    g = math.gcd(orig, new)
    o, n = orig // g, new // g
    base = min(o, n) * rolloff
    width = math.ceil(width_zeros * o / base)
    idx = torch.arange(-width, width + o, dtype=torch.float64) / o
    t = torch.arange(0, -n, -1, dtype=torch.float64)[:, None] / n + idx[None]
    t = (t * base).clamp(-width_zeros, width_zeros)
    window = torch.cos(t * math.pi / width_zeros / 2) ** 2
    t = t * math.pi
    kernel = torch.where(t == 0, torch.ones_like(t), torch.sin(t) / t) * window * base / o
    kernel = kernel.to(x.dtype).to(x.device)
    xp = F.pad(x[None, None], (width, width + o))
    y = F.conv1d(xp, kernel[:, None, :], stride=o)[0].t().reshape(-1)
    return y[: math.ceil(n * x.shape[-1] / o)]


def _mel_fb(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    f_pts = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_mels + 2))
    lo, mid, hi = f_pts[:-2], f_pts[1:-1], f_pts[2:]
    up = (freqs[:, None] - lo[None]) / (mid - lo)[None]
    down = (hi[None] - freqs[:, None]) / (hi - mid)[None]
    return np.maximum(0.0, np.minimum(up, down))


def _dct(n_mfcc: int, n_mels: int) -> np.ndarray:
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None]
    d = np.cos(math.pi / n_mels * (n + 0.5) * k) * math.sqrt(2.0 / n_mels)
    d[:, 0] /= math.sqrt(2.0)
    return d


def mfcc(x: torch.Tensor, sr: int, hop: int = 734, n_fft: int = 2048, n_mels: int = 256,
         n_mfcc: int = 64, top_db: float = 80.0) -> torch.Tensor:
    """(T,) waveform -> (frames, n_mfcc)."""
    win = torch.hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, n_fft, hop, window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec.abs() ** 2                                       # (bins, frames)
    fb = torch.as_tensor(_mel_fb(sr, n_fft, n_mels), dtype=x.dtype, device=x.device)
    db = 10.0 * torch.log10((power.t() @ fb).clamp_min(1e-10))
    db = torch.maximum(db, db.max() - top_db)
    return db @ torch.as_tensor(_dct(n_mfcc, n_mels), dtype=x.dtype, device=x.device)


def get_mfcc(wav16k: torch.Tensor, sr: int = 22000) -> torch.Tensor:
    """16 kHz waveform -> MFCC at `sr`, 30 fps."""
    return mfcc(resample(wav16k, 16000, sr), sr)

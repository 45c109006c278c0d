"""Audio front end: wav loading, sinc resampling and MFCC, in PyTorch.

Port of talkshow_tpu/ops/audio.py:39-244.  The numpy builders (polyphase
resampling kernel, periodic Hann window, HTK mel filterbank, orthonormal
DCT-II) are copied, not imported, and tests/test_torch_ops.py holds them
equal to the originals.  Everything after `load_wav` runs on the device of
the waveform tensor: framing is `unfold` over a reflect-padded signal, the
power spectrum is `torch.fft.rfft`, and the mel projection and DCT are
matmuls.

`mfcc` takes a waveform (T,) or a batch (N, T); the amplitude_to_db floor
(`max - top_db`) is taken over each clip on its own, as the reference
takes it over the one clip it is given.
"""
from __future__ import annotations

import math
import wave
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 2048
N_MELS = 256
N_MFCC = 64
TOP_DB = 80.0
AMIN = 1e-10


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (mono float32 in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        nch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if nch > 1:
        x = x.reshape(-1, nch).mean(axis=1)
    return x, sr


# ---------------------------------------------------------------------------
# numpy tables (copies of the JAX package's builders)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """Polyphase windowed-sinc kernel, (new_freq_g, 1, kernel_width), + width."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2
    t = t * math.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32)[:, None, :], width, orig, new


@lru_cache(maxsize=8)
def _hann_window(win_length: int) -> np.ndarray:
    # periodic Hann, as torch.hann_window default
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_length))).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """HTK-scale triangular mel filterbank, (n_freqs, n_mels), norm=None."""
    f_max = f_max if f_max is not None else sr / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def dct_matrix(n_mfcc: int = N_MFCC, n_mels: int = N_MELS) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_mels, n_mfcc), as torchaudio create_dct."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k) * math.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    return dct.astype(np.float32)


# ---------------------------------------------------------------------------
# tensor ops
# ---------------------------------------------------------------------------

def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample a 1-D waveform; matches torchaudio.transforms.Resample defaults.

    The polyphase kernel runs as one strided conv with `new` output
    channels; interleaving the channels gives the output samples in order.
    """
    if orig_freq == new_freq:
        return x
    kernel, width, orig, new = _resample_kernel(orig_freq, new_freq)
    length = x.shape[-1]
    xp = F.pad(x.reshape(1, 1, -1), (width, width + orig))
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    y = F.conv1d(xp, w, stride=orig)              # (1, new, n)
    y = y[0].T.reshape(-1)                        # interleave the phases
    target_len = int(math.ceil(new * length / orig))
    return y[:target_len]


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-pad (reflect) and frame: (..., T) -> (..., num_frames, n_fft)."""
    lead = x.shape[:-1]
    pad = n_fft // 2
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = xp[:, 0].unfold(-1, n_fft, hop)
    return frames.reshape(lead + frames.shape[-2:])


def power_spectrogram(x: torch.Tensor, n_fft: int = N_FFT,
                      hop: int = 734) -> torch.Tensor:
    """(..., T) -> (..., num_frames, n_fft//2+1) power (hann, center, reflect)."""
    window = torch.as_tensor(_hann_window(n_fft), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * window, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def amplitude_to_db(power: torch.Tensor, top_db: float = TOP_DB) -> torch.Tensor:
    """10*log10(clamp(x)) with a top_db floor below the max of each clip.

    power: (..., frames, bins); the max is taken over the last two axes,
    so every clip of a batch keeps its own floor."""
    x_db = 10.0 * torch.log10(torch.clamp(power, min=AMIN))
    peak = x_db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(x_db, peak - top_db)


def mfcc(x: torch.Tensor, sr: int, fps: int = 30, n_mfcc: int = N_MFCC,
         n_mels: int = N_MELS, n_fft: int = N_FFT) -> torch.Tensor:
    """Waveform (..., T) -> MFCC (..., num_frames, n_mfcc).

    Reference hop choice: 734 @30fps, 1467 @15fps (tuned for 22 kHz)."""
    if fps == 30:
        hop = 734
    elif fps == 15:
        hop = 1467
    else:
        hop = int(round(sr / fps))
    power = power_spectrogram(x, n_fft, hop)
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=x.device)
    dct = torch.as_tensor(dct_matrix(n_mfcc, n_mels), device=x.device)
    return amplitude_to_db(power @ fb) @ dct


def get_mfcc(audio_fn: str, sr: int = 22000, fps: int = 30,
             device: torch.device | str = "cuda") -> torch.Tensor:
    """wav path -> (T_frames, 64) float32 on `device`; == the reference's
    get_mfcc_ta(type='mfcc')."""
    x, sr0 = load_wav(audio_fn)
    x = torch.as_tensor(x, device=device)
    if sr0 != sr:
        x = resample(x, sr0, sr)
    return mfcc(x, sr, fps=fps)

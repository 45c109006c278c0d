"""Audio front end: wav loading, sinc resampling, MFCC and onset times, in
PyTorch.

Port of talkshow_tpu/ops/audio.py:39-354.  The numpy tables (polyphase
resampling kernel, periodic Hann window, HTK mel filterbank, orthonormal
DCT-II) are copied, not imported, and tests/test_torch_ops.py holds them
equal to the originals.  Everything after `load_wav` runs on the device of
the waveform tensor: framing is `unfold` over a reflect-padded signal, the
power spectrum is `torch.fft.rfft`, and the mel projection and DCT are
matmuls.

`onset_times` (the beat-consistency metric's audio beats) computes its
power spectrogram on the device and its slaney mel projection, spectral
flux and peak picking on the host in numpy, as the JAX module does.

`mfcc` takes a waveform (T,) or a batch (N, T); the amplitude_to_db floor
(`max - top_db`) is taken over each clip on its own, as the reference
takes it over the one clip it is given.

Traced (`talkshow_torch.tracing`): `load_wav` is the span ``wav_read``,
`resample` the span ``resample``, `get_mfcc` the span ``mfcc``; the copies
of the samples and of the numpy tables to the device there go through
`tracing.to_device`.
"""
from __future__ import annotations

import math
import wave
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from talkshow_torch.tracing import span, to_device

N_FFT = 2048
N_MELS = 256
N_MFCC = 64
TOP_DB = 80.0
AMIN = 1e-10


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (mono float32 in [-1, 1], sample_rate)."""
    with span("wav_read") as sp:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            sw = w.getsampwidth()
            nch = w.getnchannels()
            raw = w.readframes(n)
        sp.set(samples=n)
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
    """Resample each row of a waveform (..., T) on its own; matches
    torchaudio.transforms.Resample defaults (the JAX package vmaps its 1-D
    version over a batch the same way).

    The polyphase kernel runs as one strided conv with `new` output
    channels; interleaving the channels gives the output samples in order.
    """
    if orig_freq == new_freq:
        return x
    with span("resample", orig=orig_freq, new=new_freq):
        kernel, width, orig, new = _resample_kernel(orig_freq, new_freq)
        lead, length = x.shape[:-1], x.shape[-1]
        xp = F.pad(x.reshape(-1, 1, length), (width, width + orig))
        w = to_device(kernel, x.device, x.dtype)
        y = F.conv1d(xp, w, stride=orig)              # (N, new, n)
        y = y.transpose(1, 2).reshape(y.shape[0], -1)  # interleave the phases
        target_len = int(math.ceil(new * length / orig))
        return y[:, :target_len].reshape(lead + (target_len,))


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
    window = to_device(_hann_window(n_fft), x.device, x.dtype)
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
    fb = to_device(mel_filterbank(sr, n_fft, n_mels), x.device)
    dct = to_device(dct_matrix(n_mfcc, n_mels), x.device)
    return amplitude_to_db(power @ fb) @ dct


def get_mfcc(audio_fn: str, sr: int = 22000, fps: int = 30,
             device: torch.device | str = "cuda") -> torch.Tensor:
    """wav path -> (T_frames, 64) float32 on `device`; == the reference's
    get_mfcc_ta(type='mfcc')."""
    with span("mfcc") as sp:
        x, sr0 = load_wav(audio_fn)
        x = to_device(x, device)
        if sr0 != sr:
            x = resample(x, sr0, sr)
        out = mfcc(x, sr, fps=fps)
        sp.set(frames=out.shape[0])
        return out


def get_mfcc_sepa(audio_fn: str, sr: int = 16000, fps: int = 30,
                  device: torch.device | str = "cuda") -> tuple[torch.Tensor, int]:
    """Two-segment MFCC of the continuity path (reference utils.py:234-263,
    JAX ops/audio.py:247-257): the waveform is split at 2 s and each part
    featurized on its own.  Returns (features (T0 + T1, 64) on `device`,
    gap = T0)."""
    x, sr0 = load_wav(audio_fn)
    x = torch.as_tensor(x, device=device)
    if sr0 != sr:
        x = resample(x, sr0, sr)
    a = mfcc(x[: sr * 2], sr, fps=fps)
    b = mfcc(x[sr * 2:], sr, fps=fps)
    return torch.cat([a, b], dim=0), a.shape[0]


def get_raw_16k(audio_fn: str) -> np.ndarray:
    """wav path -> the raw 16 kHz waveform (N, 1) float32, the 'faceformer'
    feature (utils.py:196-198); resampled on the host when the file is at
    another rate."""
    x, sr0 = load_wav(audio_fn)
    if sr0 != 16000:
        x = resample(torch.as_tensor(x), sr0, 16000).numpy()
    return x.reshape(-1, 1)


def onset_times(audio_fn: str, sr: int = 16000, device: torch.device | str = "cuda") -> np.ndarray:
    """Spectral-flux onset detection in seconds (librosa.onset.onset_detect,
    units='time'), the audio beats of beat consistency (utils.py:202): mel
    spectrogram (n_fft 2048, hop 512, 128 slaney mels) -> dB with an 80 dB
    floor -> positive first difference averaged over bands -> librosa's
    default peak picking.  The spectrogram runs on `device`."""
    x, sr0 = load_wav(audio_fn)
    xt = torch.as_tensor(x, device=device)
    if sr0 != sr:
        xt = resample(xt, sr0, sr)
    hop = 512
    power = power_spectrogram(xt, 2048, hop).cpu().numpy()
    mel = power @ _slaney_mel_fb(sr, 2048, 128)
    S = 10.0 * np.log10(np.maximum(mel, 1e-10))
    S = np.maximum(S, S.max() - 80.0)
    flux = np.maximum(0.0, S[1:] - S[:-1]).mean(axis=1)
    env = np.concatenate([[0.0], flux])
    return _peak_pick(env, sr=sr, hop=hop) * hop / sr


@lru_cache(maxsize=4)
def _slaney_mel_fb(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, area-normalised mel filterbank (librosa's default),
    (n_freqs, n_mels) float32."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sr / 2.0, n_freqs)

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        return np.where(log_region,
                        15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


def _peak_pick(env: np.ndarray, sr: int, hop: int) -> np.ndarray:
    """librosa.util.peak_pick with onset_detect's default windows:
    pre_max 0.03 s, post_max 1 frame, pre_avg 0.10 s, post_avg 0.10 s + 1
    frame, wait 0.03 s, delta 0.07."""
    pre_max = int(0.03 * sr // hop)
    post_max = int(0.00 * sr // hop) + 1
    pre_avg = int(0.10 * sr // hop)
    post_avg = int(0.10 * sr // hop) + 1
    wait = int(0.03 * sr // hop)
    delta = 0.07
    n = len(env)
    peaks = []
    last = -1 - wait
    for i in range(n):
        lo_m, hi_m = max(0, i - pre_max), min(n, i + post_max)
        if env[i] != env[lo_m:hi_m].max():
            continue
        lo_a, hi_a = max(0, i - pre_avg), min(n, i + post_avg)
        if env[i] < env[lo_a:hi_a].mean() + delta:
            continue
        if i - last <= wait:
            continue
        last = i
        peaks.append(i)
    return np.asarray(peaks, dtype=np.int64)


# ---------------------------------------------------------------------------
# the reference front end's other feature types (JAX ops/audio.py:356-463)
# ---------------------------------------------------------------------------

def mel_spectrogram(x: torch.Tensor, sr: int, hop: int, n_fft: int = N_FFT,
                    n_mels: int = N_MELS) -> torch.Tensor:
    """Raw power mel spectrogram (..., num_frames, n_mels), no log: the
    reference's type='mel' feature (utils.py:179-184)."""
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=x.device)
    return power_spectrogram(x, n_fft, hop) @ fb


def get_mel(audio_fn: str, sr: int = 22000, fps: int = 30,
            device: torch.device | str = "cuda") -> np.ndarray:
    """wav path -> (frames, 256) mel power at hop 734 (30 fps) or 1467."""
    x, sr0 = load_wav(audio_fn)
    x = torch.as_tensor(x, device=device)
    if sr0 != sr:
        x = resample(x, sr0, sr)
    return mel_spectrogram(x, sr, 734 if fps == 30 else 1467).cpu().numpy()


def audio_chunking(x: torch.Tensor, frame_rate: int = 30,
                   chunk_size: int = 16000) -> torch.Tensor:
    """(T,) -> (frames, chunk_size): one chunk of audio per video frame,
    centred on the frame (utils.py:133-145; the MeshTalk front end)."""
    samples_per_frame = chunk_size // frame_rate
    padding = (chunk_size - samples_per_frame) // 2
    xp = F.pad(x, (padding, padding))
    anchors = torch.arange(chunk_size // 2, xp.shape[-1] - chunk_size // 2,
                           samples_per_frame, device=x.device)
    return xp[anchors[:, None] + torch.arange(-chunk_size // 2, chunk_size // 2,
                                              device=x.device)[None]]


def chunk_log_mel(chunks: torch.Tensor, sr: int, win: int, hop: int,
                  n_mels: int, n_fft: int = 2048) -> torch.Tensor:
    """(..., N) chunks -> (..., frames, n_mels) log mel power: frames of
    n_fft at `hop` (centred, reflect), a `win`-sample Hann window centred in
    n_fft, the HTK filterbank, log of max(mel, 1e-10)."""
    w = np.zeros(n_fft, np.float32)
    w[(n_fft - win) // 2:(n_fft - win) // 2 + win] = _hann_window(win)
    spec = torch.fft.rfft(frame_signal(chunks, n_fft, hop)
                          * torch.as_tensor(w, device=chunks.device), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=chunks.device)
    return torch.log(mel.clamp_min(1e-10))


def get_mel_chunked(audio_fn: str, sr: int = 16000, fps: int = 30,
                    device: torch.device | str = "cuda") -> np.ndarray:
    """type='mel_mul' (utils.py:185-192): loudness-normalise, one second of
    audio per frame, a log mel per chunk -> (frames, 101, 256)."""
    x, sr0 = load_wav(audio_fn)
    x = torch.as_tensor(x, device=device)
    if sr0 != sr:
        x = resample(x, sr0, sr)
    x = 0.01 * x / x.abs().mean()
    chunks = audio_chunking(x, frame_rate=fps, chunk_size=sr)
    return chunk_log_mel(chunks, sr, sr // 20, sr // 100, N_MELS).cpu().numpy()


def mfcc_psf(x: np.ndarray, sr: int = 16000, n_mfcc: int = 64,
             winstep: float = 1.01 / 15, winlen: float = 0.025,
             n_fft: int = 2048, preemph: float = 0.97) -> np.ndarray:
    """python_speech_features-style MFCC (utils.py:86-107), host numpy:
    preemphasis, 25 ms frames at `winstep`, rectangular window, HTK mels
    with nfilt = numcep, log, orthonormal DCT-II with ceplifter 22, c0
    replaced by the log frame energy (appendEnergy)."""
    x = np.asarray(x, np.float64)
    x = np.append(x[0], x[1:] - preemph * x[:-1])
    frame_len = int(round(winlen * sr))
    step = int(round(winstep * sr))
    num_frames = 1 + max(0, int(np.ceil((len(x) - frame_len) / step)))
    pad_len = (num_frames - 1) * step + frame_len
    x = np.pad(x, (0, max(0, pad_len - len(x))))
    idx = np.arange(frame_len)[None] + step * np.arange(num_frames)[:, None]
    frames = x[idx]
    energy = np.sum(frames ** 2, axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=1)) ** 2 / n_fft
    feat = spec @ np.asarray(mel_filterbank(sr, n_fft, n_mfcc), np.float64)
    feat = np.log(np.where(feat == 0, np.finfo(np.float64).eps, feat))
    ceps = feat @ np.asarray(dct_matrix(n_mfcc, n_mfcc), np.float64)
    lifter = 22
    ceps = ceps * (1 + (lifter / 2.0) * np.sin(np.pi * np.arange(n_mfcc) / lifter))
    ceps[:, 0] = np.log(energy)
    return ceps.astype(np.float32)


def get_mfcc_psf(audio_fn: str, sr: int = 16000, smlpx: bool = True,
                 fps: int = 25) -> np.ndarray:
    """wav path -> `mfcc_psf` at winstep 1.01/15 (smlpx) or 0.04; host."""
    x, sr0 = load_wav(audio_fn)
    if sr0 != sr:
        x = resample(torch.as_tensor(x), sr0, sr).numpy()
    return mfcc_psf(x, sr=sr, winstep=1.01 / 15 if smlpx else 0.04)


def smooth_geom(geom: torch.Tensor, mask: torch.Tensor | None = None,
                filter_size: int = 9, sigma: float = 2.0) -> torch.Tensor:
    """Gaussian temporal smoothing of vertex geometry (T, V, 3), edge
    padded, optionally blended through a per-vertex mask (V,)
    (utils.py:272-298)."""
    if filter_size % 2 != 1:
        raise ValueError(f"filter_size must be odd, got {filter_size}")
    r = filter_size // 2
    k = np.exp(-0.5 * np.arange(-r, r + 1) ** 2 / sigma ** 2)
    k = torch.as_tensor((k / k.sum()).astype(np.float32), device=geom.device)
    gp = torch.cat([geom[:1].expand(r, -1, -1), geom, geom[-1:].expand(r, -1, -1)])
    idx = torch.arange(geom.shape[0], device=geom.device)[:, None] \
        + torch.arange(filter_size, device=geom.device)[None]
    smoothed = torch.einsum("tkvc,k->tvc", gp[idx], k)
    if mask is None:
        return smoothed
    m = mask[None, :, None]
    return smoothed * m + geom * (1 - m)

"""The audio front end's other feature types in the port
(talkshow_torch/ops/audio.py: mel_spectrogram, get_mel, audio_chunking,
get_mel_chunked, mfcc_psf, get_mfcc_psf, smooth_geom) against
talkshow_tpu/ops/audio.py on the CPU, at tests/test_audio_variants.py's
tolerances: the mel features within rtol 2e-3 / atol 2e-5 (type='mel') and
rtol 5e-3 / atol 1e-4 (the log mel of type='mel_mul'), the chunking within
1e-7, the host-numpy MFCC (a copy) equal, the smoothing within 1e-6."""
import wave

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.ops import audio as A
from talkshow_torch.ops import audio as T

torch.set_num_threads(2)


def _write_wav(path, x, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _speechy(sr, secs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * secs)) / sr
    x = (0.4 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.2 * np.sin(2 * np.pi * 510 * t) + 0.02 * rng.standard_normal(t.size))
    return x.astype(np.float32)


@pytest.mark.parametrize("sr,fps", [(16000, 30), (22000, 15)])
def test_get_mel_matches_jax(tmp_path, sr, fps):
    p = tmp_path / "a.wav"
    _write_wav(p, _speechy(16000, 1.0), 16000)
    want = A.get_mel(str(p), sr=sr, fps=fps)
    got = T.get_mel(str(p), sr=sr, fps=fps, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5)


def test_mel_spectrogram_batched_rows_match_jax():
    x = np.stack([_speechy(16000, 0.5, s) for s in (1, 2)])
    got = T.mel_spectrogram(torch.as_tensor(x), 16000, hop=534).numpy()
    for i in range(2):
        want = np.asarray(A.mel_spectrogram(jnp.asarray(x[i]), 16000, hop=534))
        np.testing.assert_allclose(got[i], want, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("fps,chunk", [(30, 16000), (25, 8000)])
def test_audio_chunking_matches_jax(fps, chunk):
    x = _speechy(16000, 0.7, seed=3)
    want = np.asarray(A.audio_chunking(jnp.asarray(x), fps, chunk))
    got = T.audio_chunking(torch.as_tensor(x), fps, chunk).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_get_mel_chunked_matches_jax(tmp_path):
    p = tmp_path / "c.wav"
    _write_wav(p, _speechy(16000, 0.5, seed=5))
    want = A.get_mel_chunked(str(p), sr=16000, fps=30)
    got = T.get_mel_chunked(str(p), sr=16000, fps=30, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("smlpx", [True, False])
def test_mfcc_psf_equals_jax(tmp_path, smlpx):
    p = tmp_path / "d.wav"
    _write_wav(p, _speechy(16000, 0.8, seed=9))
    want = A.get_mfcc_psf(str(p), sr=16000, smlpx=smlpx)
    got = T.get_mfcc_psf(str(p), sr=16000, smlpx=smlpx)
    np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    np.testing.assert_array_equal(T.mfcc_psf(x), A.mfcc_psf(x))


@pytest.mark.parametrize("masked", [False, True])
def test_smooth_geom_matches_jax(masked):
    rng = np.random.default_rng(1)
    g = rng.standard_normal((30, 10, 3)).astype(np.float32)
    mask = np.zeros(10, np.float32)
    mask[:5] = 1.0
    want = np.asarray(A.smooth_geom(jnp.asarray(g), jnp.asarray(mask) if masked else None))
    got = T.smooth_geom(torch.as_tensor(g), torch.as_tensor(mask) if masked else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError):
        T.smooth_geom(torch.as_tensor(g), filter_size=8)

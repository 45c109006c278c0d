"""Port ops (talkshow_torch/ops) against the JAX package: copied tables are
equal to the originals; part2full and resample to atol 1e-5; mfcc to
1e-3 dB (torch.fft.rfft against jnp.fft)."""
import wave

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.ops import audio as jaudio
from talkshow_tpu.ops import pose as jpose
from talkshow_torch.ops import audio as taudio
from talkshow_torch.ops import pose as tpose

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["C_INDEX_3D", "C_INDEX_6D", "LOWER_POSE",
                                  "LOWER_POSE_STAND", "CHANGE_ANGLE"])
def test_pose_tables_equal(name):
    np.testing.assert_array_equal(getattr(tpose, name), getattr(jpose, name))


def test_pose_scalars_equal():
    for name in ("FULL_POSE_DIM", "EXPRESSION_DIM", "FULL_DIM", "CONV_DIM",
                 "BODY_DIM", "HAND_DIM", "JAW_DIM", "NUM_SPEAKERS",
                 "SPEAKER_ID", "SPEAKER_OFFSET"):
        assert getattr(tpose, name) == getattr(jpose, name), name


@pytest.mark.parametrize("freqs", [(16000, 22000), (22000, 16000), (44100, 16000)])
def test_resample_kernel_equal(freqs):
    k_t, *rest_t = taudio._resample_kernel(*freqs)
    k_j, *rest_j = jaudio._resample_kernel(*freqs)
    np.testing.assert_array_equal(k_t, k_j)
    assert rest_t == rest_j


@pytest.mark.parametrize("sr", [16000, 22000])
def test_spectral_tables_equal(sr):
    np.testing.assert_array_equal(taudio._hann_window(2048), jaudio._hann_window(2048))
    np.testing.assert_array_equal(taudio.mel_filterbank(sr), jaudio.mel_filterbank(sr))
    np.testing.assert_array_equal(taudio.dct_matrix(), jaudio.dct_matrix())


@pytest.mark.parametrize("stand", [False, True])
def test_part2full(stand):
    pred = np.random.default_rng(0).standard_normal((5, 232)).astype(np.float32)
    ref = np.asarray(jpose.part2full(jnp.asarray(pred), stand))
    out = tpose.part2full(torch.as_tensor(pred), stand).numpy()
    assert out.shape == (5, 265)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("freqs", [(16000, 22000), (22000, 16000)])
def test_resample(freqs):
    x = np.random.default_rng(1).standard_normal(4001).astype(np.float32)
    ref = np.asarray(jaudio.resample(jnp.asarray(x), *freqs))
    out = taudio.resample(torch.as_tensor(x), *freqs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _clip(seed, n=22000, amp=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22000.0
    return (amp * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("fps", [30, 15])
def test_mfcc(fps):
    x = _clip(2)
    ref = np.asarray(jaudio.mfcc(jnp.asarray(x), 22000, fps=fps))
    out = taudio.mfcc(torch.as_tensor(x), 22000, fps=fps).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_mfcc_batch_keeps_a_floor_per_clip():
    """amplitude_to_db's top-db floor is taken over each clip on its own."""
    clips = np.stack([_clip(3, amp=0.3), _clip(4, amp=1e-4) * 1e-3])
    out = taudio.mfcc(torch.as_tensor(clips), 22000).numpy()
    for i, c in enumerate(clips):
        ref = np.asarray(jaudio.mfcc(jnp.asarray(c), 22000))
        np.testing.assert_allclose(out[i], ref, atol=1e-3)


def test_get_mfcc_and_load_wav(tmp_path):
    x = _clip(5, n=16000)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    wt, srt = taudio.load_wav(path)
    wj, srj = jaudio.load_wav(path)
    np.testing.assert_array_equal(wt, wj)
    assert srt == srj == 16000
    np.testing.assert_allclose(taudio.get_mfcc(path, device="cpu").numpy(), jaudio.get_mfcc(path),
                               atol=1e-3)

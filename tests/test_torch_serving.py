"""The port's MotionServer against the JAX package's on the same weights.

With JAX's gumbel block for each (bucket, group) key, a flush serves the
same motion as JAX's server (atol 1e-4, the pipeline tests' motion
tolerance; tokens equal).  The port's own guarantees mirror
tests/test_serving.py: the masked face stage equals the unpadded clip's
(2e-5), int16 transfer equals float32, a clip on a bucket's boundary
fits, a failed group keeps its requests queued, default flushes draw
fresh noise, and traffic only meets (bucket, max_batch) shapes."""
import numpy as np
import jax
import pytest
import torch

from talkshow_tpu.serving import MotionServer as JMotionServer
from talkshow_torch import serving
from talkshow_torch.kernels import counts
from talkshow_torch.serving import MotionServer
from test_torch_harness import K, jax_noise_from_key, pipeline_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipes():
    return pipeline_pair(0)


def _wav(seconds, seed=0):
    """Speech stand-in on the int16 PCM grid (int16 transfer is exact)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(int(16000 * seconds)) * 0.1 * 32768.0)
    return (np.clip(x, -32768, 32767) / 32768.0).astype(np.float32)


def jax_group_noise(max_batch):
    """The block JAX's server draws for a group: keys[0] of
    split(fold_in(fold_in(PRNGKey(base), bucket), index), max_batch)
    (serving.py:125-133,286-288)."""
    def noise(base, bucket, index, rows):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(base), bucket), index)
        key = jax.random.split(key, max_batch)[0]
        return torch.as_tensor(jax_noise_from_key(key, rows, max_batch, K))
    return noise


def test_served_motion_matches_jax(pipes):
    jp, tp = pipes
    js = JMotionServer(jp, bucket_frames=16, max_batch=2)
    ts = MotionServer(tp, bucket_frames=16, max_batch=2, noise=jax_group_noise(2))
    clips = [(0.5, 0, 0), (0.9, 1, 1), (0.4, 2, 2), (0.45, 3, 3)]   # buckets 16, 32, 16, 16
    jr = [js.submit(_wav(sec, s), speaker=spk) for sec, s, spk in clips]
    tr = [ts.submit(_wav(sec, s), speaker=spk) for sec, s, spk in clips]
    assert ts.pending() == 4
    ref = js.flush(seed=7)
    counts.clear()
    out = ts.flush(seed=7)
    assert ts.pending() == 0
    # one decode and one face pass per group: bucket 16 holds two groups
    assert counts["sample_tokens_plain"] == 3 and counts["face_plain"] == 3
    for a, b, (sec, _, _) in zip(jr, tr, clips):
        frames = int(int(16000 * sec) * 30 // 16000)
        assert out[b].shape == ref[a].shape == (frames, 265)
        np.testing.assert_allclose(out[b], ref[a], atol=1e-4)


def test_masked_face_equals_unpadded(pipes):
    _, tp = pipes
    wav = _wav(0.5, 3)
    server = MotionServer(tp, bucket_frames=16, max_batch=2)
    rid = server.submit(wav, speaker=0)
    out = server.flush()[rid]
    ref = tp.generate_face(wav, frame=int(len(wav) * 30 // 16000))
    np.testing.assert_allclose(out[:, :3], ref[:, :3], atol=2e-5)
    np.testing.assert_allclose(out[:, -100:], ref[:, 3:], atol=2e-5)


def test_int16_transfer_matches_float32(pipes):
    _, tp = pipes
    wav = _wav(0.5, 31)
    s_i = MotionServer(tp, bucket_frames=16, max_batch=2)
    s_f = MotionServer(tp, bucket_frames=16, max_batch=2, transfer_dtype="float32")
    r_i, r_f = s_i.submit(wav, speaker=2), s_f.submit(wav, speaker=2)
    out_i, out_f = s_i.flush(seed=3)[r_i], s_f.flush(seed=3)[r_f]
    np.testing.assert_array_equal(out_i, out_f)
    r_p = s_i.submit((wav * 32768.0).astype(np.int16), speaker=2)   # raw PCM
    np.testing.assert_array_equal(s_i.flush(seed=3)[r_p], out_i)
    with pytest.raises(ValueError):
        MotionServer(tp, transfer_dtype="float16")


def test_bucket_boundary_audio_fits(pipes):
    """A wav with more than bucket * ceil(16000/30) samples whose frame
    count still equals the bucket is served whole."""
    _, tp = pipes
    server = MotionServer(tp, bucket_frames=32, max_batch=2)
    wav = _wav(17089 / 16000, 7)
    assert len(wav) == 17089
    rid = server.submit(wav, speaker=0)
    out = server.flush()[rid]
    assert out.shape == (32, 265) and np.isfinite(out).all()


def test_flush_failure_keeps_unserved_requests(pipes, monkeypatch):
    _, tp = pipes
    server = MotionServer(tp, bucket_frames=16, max_batch=2)
    server.submit(_wav(0.4, 0))                      # bucket 16
    r1 = server.submit(_wav(0.9, 1))                 # bucket 32
    real = server._run_group

    def boom(bucket, B, requests, base=0, index=0):
        if bucket == 32:
            raise RuntimeError("injected")
        return real(bucket, B, requests, base, index)

    monkeypatch.setattr(server, "_run_group", boom)
    with pytest.raises(RuntimeError):
        server.flush()
    assert [r.rid for r in server._queue] == [r1]
    monkeypatch.setattr(server, "_run_group", real)
    assert set(server.flush()) == {r1}


def test_flush_noise_is_fresh_across_flushes(pipes):
    _, tp = pipes
    server = MotionServer(tp, bucket_frames=16, max_batch=2)
    wav = _wav(0.5, 9)
    m = []
    for seed in (None, None, 5, 5):
        r = server.submit(wav)
        m.append(server.flush(seed=seed)[r])
    assert not np.array_equal(m[0], m[1])
    np.testing.assert_array_equal(m[2], m[3])


def test_traffic_meets_only_bucket_max_batch_shapes(pipes, monkeypatch):
    """warmup() runs each bucket once at max_batch; later traffic of any
    length up to the limit meets no other face or decode shape."""
    _, tp = pipes
    shapes = {"face": [], "decode": []}
    face_stage, decode = tp.face_stage, serving.generate_conv_poses

    def face_spy(wav, onehot, frames, *a, **kw):
        shapes["face"].append((tuple(wav.shape), frames))
        return face_stage(wav, onehot, frames, *a, **kw)

    def decode_spy(body, feat, ids, **kw):
        shapes["decode"].append(tuple(feat.shape))
        return decode(body, feat, ids, **kw)

    monkeypatch.setattr(tp, "face_stage", face_spy)
    monkeypatch.setattr(serving, "generate_conv_poses", decode_spy)
    server = MotionServer(tp, bucket_frames=16, max_batch=2)
    assert server.warmup(max_clip_seconds=1.1) == 3          # buckets 16, 32, 48
    warm = {k: set(v) for k, v in shapes.items()}
    assert len(warm["face"]) == len(warm["decode"]) == 3
    assert all(s[0][0] == 2 for s in warm["face"]) and all(s[0] == 2 for s in warm["decode"])
    for i, sec in enumerate([0.3, 0.5, 0.52, 0.8, 1.0, 1.09]):
        server.submit(_wav(sec, 10 + i), speaker=i % 4)
    assert len(server.flush()) == 6
    assert {k: set(v) for k, v in shapes.items()} == warm

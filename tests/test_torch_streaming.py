"""The port's StreamingSession against the JAX package's on the same
weights.

With JAX's gumbel block for each step's key (fold_in(PRNGKey(seed),
rows_done)), uneven feeds and the tail give the same token history bit for
bit and the same motion (atol 1e-4) as JAX's session.  The port's own
guarantees mirror tests/test_streaming.py: at most
ceil(context_rows / chunk_rows) + 1 window shapes, bounded audio and token
state over a long session, the true last tokens as each step's prefix, and
feed() after finish() raising."""
import numpy as np
import jax
import pytest
import torch

from talkshow_tpu.streaming import StreamingSession as JStreamingSession
from talkshow_torch import streaming
from talkshow_torch.kernels import counts
from talkshow_torch.streaming import StreamingSession, samples_for
from test_torch_harness import K, jax_noise_from_key, pipeline_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipes():
    return pipeline_pair(0)


def _wav(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def jax_step_noise(seed):
    """The block JAX's session draws for the step at rows_done
    (streaming.py:158-160)."""
    def noise(rows_done, rows):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rows_done)
        return torch.as_tensor(jax_noise_from_key(key, rows, 1, K))
    return noise


def _stream(sess, wav, step=5000):
    blocks, hist = [], []
    for i in range(0, len(wav), step):          # uneven feeds against the chunk size
        out = sess.feed(wav[i:i + step])
        if out is not None:
            blocks.append(out)
            hist.append(np.array(sess._tokens))
    tail = sess.finish()
    if tail is not None:
        blocks.append(tail)
        hist.append(np.array(sess._tokens))
    return np.concatenate(blocks), hist


def test_blocks_and_tail_match_jax(pipes):
    jp, tp = pipes
    wav = _wav(3.0, 0)                          # 90 frames: 11 blocks of 8 + a tail of 2
    ref, ref_hist = _stream(JStreamingSession(jp, speaker=1, chunk_rows=2, context_rows=4,
                                              seed=3), wav)
    counts.clear()
    sess = StreamingSession(tp, speaker=1, chunk_rows=2, context_rows=4,
                            noise=jax_step_noise(3))
    out, hist = _stream(sess, wav)
    assert counts["sample_tokens_plain"] == counts["face_plain"] == 12
    assert len(hist) == len(ref_hist)
    for a, b in zip(hist, ref_hist):
        np.testing.assert_array_equal(a, b)
    assert out.shape == ref.shape == (90, 265) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_window_shapes_are_bounded(pipes, monkeypatch):
    _, tp = pipes
    shapes = set()
    face_stage = tp.face_stage

    def spy(wav, onehot, frames, *a, **kw):
        shapes.add((tuple(wav.shape), frames))
        return face_stage(wav, onehot, frames, *a, **kw)

    monkeypatch.setattr(tp, "face_stage", spy)
    sess = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=4)
    sess.feed(_wav(4.0, 1))
    assert len(shapes) == 3                       # ceil(4 / 2) + 1


def test_long_session_bounded_state(pipes):
    """50 feeds through one session: state stays window-sized, block
    accounting stays exact, every block is finite."""
    _, tp = pipes
    sess = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=4)
    total = 0
    rng = np.random.default_rng(4)
    for _ in range(50):
        out = sess.feed((rng.standard_normal(4266) * 0.1).astype(np.float32))
        if out is not None:
            assert out.shape[1] == 265 and np.isfinite(out).all()
            total += out.shape[0]
    assert len(sess._wav) <= samples_for((sess.context_rows + sess.chunk_rows) * 4) + 4266
    assert sess._tokens.shape == (sess.context_rows, 2)
    assert total == sess._emitted_frames


def test_prefix_carries_the_true_last_tokens(pipes, monkeypatch):
    """Each step's teacher-forced prefix is the last context_rows tokens the
    session emitted, and the same seed reproduces a session."""
    _, tp = pipes
    decode = streaming.generate_conv_poses
    steps = []

    def spy(body, feat, ids, **kw):
        conv, tokens = decode(body, feat, ids, **kw)
        steps.append((kw["prefix_tokens"][0, :kw["prefix_len"]].clone(), tokens[0].clone(),
                      kw["prefix_len"]))
        return conv, tokens

    monkeypatch.setattr(streaming, "generate_conv_poses", spy)
    sess = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=2, seed=5)
    sess.feed(_wav(2.0, 2))
    assert len(steps) >= 6 and [s[2] for s in steps[:3]] == [0, 2, 2]
    emitted = torch.cat([tok[n:] for _, tok, n in steps])
    done = 0
    for prefix, tok, n in steps:
        np.testing.assert_array_equal(prefix.numpy(), emitted[done - n:done].numpy())
        np.testing.assert_array_equal(tok[:n].numpy(), prefix.numpy())
        done += tok.shape[0] - n
    again = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=2, seed=5)
    again.feed(_wav(2.0, 2))
    np.testing.assert_array_equal(sess._tokens, again._tokens)
    other = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=2, seed=6)
    other.feed(_wav(2.0, 2))
    assert not np.array_equal(sess._tokens, other._tokens)


def test_finish_closes_session(pipes):
    _, tp = pipes
    sess = StreamingSession(tp, speaker=0, chunk_rows=2, context_rows=4)
    sess.feed(_wav(1.0, 3))
    sess.finish()
    with pytest.raises(RuntimeError, match="finish"):
        sess.feed(_wav(0.5, 4))
    assert sess.finish() is None

"""The port's VQ ops (talkshow_torch/ops/vq.py, kernels/nearest_code.py)
against the JAX package's (talkshow_tpu/ops/vq.py) on the CPU.

Tolerances: the plain nearest-code search equals the JAX Pallas kernel run
in interpret mode index for index (random f32 inputs hold no near-ties);
quantized values, commitment loss, every VQState field and the
straight-through gradient agree within rtol 1e-5 (the same f32 math, the
code sums dw = onehot^T @ flat summed in another order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from talkshow_tpu.ops import vq as jvq
from talkshow_torch.kernels import counts
from talkshow_torch.kernels.nearest_code import nearest_code_kernel
from talkshow_torch.ops import vq as tvq

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _f32(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _states(seed, K, D):
    js = jvq.init_vq_state(jax.random.PRNGKey(seed), K, D)
    rng = np.random.default_rng(seed)
    # non-zero EMA statistics and a counter past 0, so every term of the update matters
    js = jvq.VQState(js.embeddings, jnp.asarray(_f32(rng, (K, D), 0.01)),
                     jnp.asarray(rng.uniform(0.5, 2.0, K).astype(np.float32)),
                     jnp.asarray(4, jnp.int32))
    return js, tvq.VQState(*(torch.tensor(np.asarray(a)) for a in js))


def test_nearest_code_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    x, emb = _f32(rng, (300, 64)), _f32(rng, (2048, 64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jvq.nearest_code_pallas(jnp.asarray(x), jnp.asarray(emb)))
    counts.clear()
    got = tvq.nearest_code(torch.as_tensor(x), torch.as_tensor(emb))
    assert counts["nearest_code_plain"] == 1 and counts["nearest_code"] == 0
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_code_ties_pick_the_lowest_index():
    rng = np.random.default_rng(1)
    emb = _f32(rng, (16, 8))
    emb[9] = emb[3]
    emb[12] = emb[3]
    x = np.stack([emb[3], emb[12], np.zeros(8, np.float32)])
    emb[5] = emb[6] = 0.0          # x = 0 is equally far from both zero codes
    got = tvq.nearest_code_plain(torch.as_tensor(x), torch.as_tensor(emb))
    want = np.asarray(jvq.nearest_code_xla(jnp.asarray(x), jnp.asarray(emb)))
    np.testing.assert_array_equal(got.numpy(), [3, 3, 5])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,K", [((4, 6, 16), 32), ((2, 22, 64), 2048)])
def test_quantize_matches_jax(shape, K):
    js, ts = _states(2, K, shape[-1])
    z = _f32(np.random.default_rng(3), shape, 0.05)
    jq, jidx = jvq.quantize(js, jnp.asarray(z))
    tq, tidx = tvq.quantize(ts, torch.as_tensor(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,K", [((4, 6, 16), 32), ((2, 22, 64), 2048)])
def test_quantize_train_matches_jax(shape, K):
    js, ts = _states(4, K, shape[-1])
    rng = np.random.default_rng(5)
    z, w = _f32(rng, shape, 0.05), _f32(rng, shape)

    def jloss(zz):
        q, commit, _, _ = jvq.quantize_train(js, zz)
        return jnp.sum(q * w) + commit

    jq, jcommit, jnew, jidx = jvq.quantize_train(js, jnp.asarray(z))
    jgrad = jax.grad(jloss)(jnp.asarray(z))
    tz = torch.tensor(z, requires_grad=True)
    tq, tcommit, tnew, tidx = tvq.quantize_train(ts, tz)
    (torch.sum(tq * torch.as_tensor(w)) + tcommit).backward()

    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcommit.detach().item(), float(jcommit), rtol=RTOL)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgrad), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(tvq.VQState._fields, tnew, jnew):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_quantize_train_three_calls_advance_the_counter():
    js, ts = _states(6, 32, 16)
    z = _f32(np.random.default_rng(7), (40, 16), 0.05)
    for _ in range(3):
        _, _, js, _ = jvq.quantize_train(js, jnp.asarray(z))
        _, _, ts, _ = tvq.quantize_train(ts, torch.as_tensor(z))
    assert int(ts.counter) == int(js.counter) == 7
    for name, a, b in zip(tvq.VQState._fields, ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_nearest_code_kernel_raises_on_cpu_tensors():
    x, emb = torch.zeros((4, 8)), torch.zeros((16, 8))
    with pytest.raises(ValueError):
        nearest_code_kernel(x, emb)


W2V_TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_wav2vec_vq_encoder_matches_jax(train):
    """Wav2VecVQEncoder (tests/test_misc_gaps.py's tiny config, 1 s at 28
    frames -> 7 rows) against flax within 1e-4: eval mode on the CPU is the
    plain encoder with running statistics; train mode the batch statistics,
    the running ones updated."""
    from talkshow_tpu.models.vqvae import Wav2VecVQEncoder as JEnc
    from talkshow_tpu.models.wav2vec import Wav2Vec2Config as JCfg
    from talkshow_torch.convert import convert_wav2vec_vq_encoder
    from talkshow_torch.models.vqvae import Wav2VecVQEncoder
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    wav = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32)
    jm = JEnc(num_hiddens=32, wav2vec_cfg=JCfg(**W2V_TINY))
    v = jax.jit(lambda w: jm.init(jax.random.PRNGKey(0), w, 28))(jnp.asarray(wav))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if jax.tree_util.keystr(p).endswith("['var']")
                      else np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v)
    tm = Wav2VecVQEncoder(num_hiddens=32, wav2vec_cfg=Wav2Vec2Config(**W2V_TINY))
    tm.load_state_dict(convert_wav2vec_vq_encoder(jax.tree.map(np.asarray, v)))
    tm.train(train)
    if train:
        ref, upd = jax.jit(lambda vv, w: jm.apply(vv, w, 28, True, mutable=["batch_stats"]))(
            v, jnp.asarray(wav))
    else:
        ref = jax.jit(lambda vv, w: jm.apply(vv, w, 28))(v, jnp.asarray(wav))
    out = tm(torch.as_tensor(wav), 28)
    assert out.shape == ref.shape == (2, 7, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)
    if train:
        sd = tm.state_dict()
        for k, want in convert_wav2vec_vq_encoder(
                {"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])}).items():
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), atol=1e-4)

"""The port's streaming VQ-VAE (talkshow_torch/models/causal_vqvae.py)
against talkshow_tpu/models/causal_vqvae.py on the CPU, at toy widths (in
12, 32 hidden, a 32-code codebook of width 64), weights from JAX's init,
perturbed (running variances kept positive), through
`convert.convert_causal_vqvae`.

Tolerances: latents, decoded poses, the commit loss, the EMA state and the
BatchNorm statistics within 1e-5 of their largest (the same f32 math summed
in another order); token indices equal exactly.  The JAX package's own
rules hold in the port too: chunked decoding with carried state equals the
full decode within 1e-5 (tests/test_extras.py:103-120), chunked encoding
gives the full encode's tokens, and perturbing the last frame moves only
the last latent row (:123-134)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models.causal_vqvae import CausalVQVAE as JCausalVQVAE
from talkshow_tpu.ops import vq as jvq
from talkshow_torch import convert
from talkshow_torch.kernels import counts
from talkshow_torch.models.causal_vqvae import CausalVQVAE
from talkshow_torch.ops import vq as tvq

torch.set_num_threads(2)
IN, NH, CODES, T, B = 12, 32, 32, 16, 2


def _close(got, want, tag):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= 1e-5 * scale, (tag, np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def pair():
    jm = JCausalVQVAE(in_dim=IN, num_hiddens=NH)
    st = jvq.init_vq_state(jax.random.PRNGKey(0), CODES, 64)
    x = jnp.zeros((1, T, IN))
    jv = jax.jit(jm.init)(jax.random.PRNGKey(1), x, st)
    rng = np.random.default_rng(3)

    def perturb(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    jv = jax.tree_util.tree_map_with_path(perturb, jv)
    tm = CausalVQVAE(IN, num_hiddens=NH).eval()
    tm.load_state_dict(convert.convert_causal_vqvae(jv))
    tst = tvq.VQState(*(torch.tensor(np.asarray(a)) for a in st))
    return jm, jax.tree.map(jnp.asarray, jv), st, tm, tst


def _poses(seed, t=T):
    return np.random.default_rng(seed).standard_normal((B, t, IN)).astype(np.float32)


def test_encode_latents_matches_jax(pair):
    jm, jv, _, tm, _ = pair
    x = _poses(0)
    z, _ = jm.apply(jv, jnp.asarray(x), None, method=JCausalVQVAE.encode_latents)
    with torch.no_grad():
        got, states = tm.encode_latents(torch.as_tensor(x))
    assert got.shape == (B, T // 4, 64) and [len(s) for s in states] == [2, 2, 2]
    _close(got, z, "latents")


@pytest.mark.parametrize("chunk", [T, 4, 8])
def test_encode_chunk_tokens_match_jax(pair, chunk):
    """JAX's encode_chunk over chunks of `chunk` frames with carried state
    and the port's give the same tokens, which are the full clip's."""
    jm, jv, st, tm, tst = pair
    x = _poses(1)
    j_idx, t_idx, states_j, states_t = [], [], None, None
    counts.clear()
    for i in range(0, T, chunk):
        q, idx, states_j = jm.apply(jv, jnp.asarray(x[:, i:i + chunk]), st, states_j,
                                    method=JCausalVQVAE.encode_chunk)
        j_idx.append(np.asarray(idx))
        with torch.no_grad():
            tq, ti, states_t = tm.encode_chunk(torch.as_tensor(x[:, i:i + chunk]), tst, states_t)
        t_idx.append(ti.numpy())
        _close(tq, q, f"quantized chunk {i}")
    assert counts["nearest_code_plain"] == T // chunk
    np.testing.assert_array_equal(np.concatenate(t_idx, 1), np.concatenate(j_idx, 1))
    with torch.no_grad():
        _, full, _ = tm.encode_chunk(torch.as_tensor(x), tst)
    np.testing.assert_array_equal(np.concatenate(t_idx, 1), full.numpy())


def test_decode_chunk_matches_jax_and_chunked_equals_full(pair):
    jm, jv, st, tm, tst = pair
    idx = np.random.default_rng(2).integers(0, CODES, (B, T // 4)).astype(np.int32)
    want, _ = jm.apply(jv, jnp.asarray(idx), st, None, method=JCausalVQVAE.decode_chunk)
    with torch.no_grad():
        full, _ = tm.decode_chunk(torch.as_tensor(idx).long(), tst)
        outs, states = [], None
        for i in range(T // 4):
            out, states = tm.decode_chunk(torch.as_tensor(idx[:, i:i + 1]).long(), tst, states)
            outs.append(out)
    assert full.shape == (B, T, IN)
    _close(full, want, "decode")
    _close(torch.cat(outs, 1), full.numpy(), "chunked decode")


def test_encoder_is_causal(pair):
    _, _, _, tm, _ = pair
    x = torch.as_tensor(_poses(4))
    x2 = x.clone()
    x2[:, -1] += 10.0
    with torch.no_grad():
        z0, _ = tm.encode_latents(x)
        z1, _ = tm.encode_latents(x2)
    assert torch.equal(z0[:, :-1], z1[:, :-1]) and not torch.equal(z0[:, -1], z1[:, -1])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(pair, train):
    """The whole-clip forward: recon, commit loss, the new VQ state and, in
    train mode, the BatchNorm statistics it updates."""
    jm, jv, st, tm, tst = pair
    x = _poses(5)
    if train:
        (recon, commit, new_st, idx), upd = jm.apply(jv, jnp.asarray(x), st, True,
                                                      mutable=["batch_stats"])
    else:
        recon, commit, new_st, idx = jm.apply(jv, jnp.asarray(x), st, False)
    m = CausalVQVAE(IN, num_hiddens=NH)
    m.load_state_dict(tm.state_dict())
    m.train(train)
    got = m(torch.as_tensor(x), tst)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(idx))
    _close(got[0], recon, "recon")
    np.testing.assert_allclose(float(got[1].detach()), float(commit), rtol=1e-5, atol=1e-8)
    for a, b, f in zip(got[2], new_st, tvq.VQState._fields):
        _close(a, b, f)
    if train:
        want = convert.convert_causal_vqvae({"batch_stats": upd["batch_stats"]})
        sd = m.state_dict()
        for k, v in want.items():
            _close(sd[k], v, k)

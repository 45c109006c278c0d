"""Port conv building blocks, VQ decoder and audio encoder against flax, to
atol 1e-4.  Weights (with random BatchNorm statistics, so eval-mode BN is
not the identity) cross through talkshow_torch.convert."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models import layers as jl
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.ops import vq as jvq
from talkshow_torch import convert
from talkshow_torch.models import layers as tl
from talkshow_torch.models import vqvae as tv
from talkshow_torch.ops import vq as tvq

torch.set_num_threads(2)
ATOL = 1e-4


def _randomize(variables, seed):
    """Perturb every leaf; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(jmod, tmod, x, state_dict_fn, seed=0, **apply_kw):
    variables = _randomize(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), **apply_kw))
    tmod.load_state_dict(state_dict_fn(variables))
    with torch.no_grad():
        out = tmod.eval()(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("sample,residual,cin,cout", [
    ("none", False, 8, 12), ("none", True, 12, 12), ("none", True, 8, 12),
    ("one", False, 8, 12), ("down", True, 8, 12), ("down", False, 8, 12),
    ("up", True, 12, 8), ("up", False, 12, 8)])
@pytest.mark.parametrize("leaky", [False, True])
def test_conv_norm_relu(sample, residual, cin, cout, leaky):
    _compare(jl.ConvNormRelu(cout, leaky=leaky, sample=sample, residual=residual),
             tl.ConvNormRelu(cin, cout, leaky=leaky, sample=sample, residual=residual),
             _x((2, 16, cin)), convert.convert_audio_encoder)


def test_res_cnr_stack():
    _compare(jl.ResCNRStack(12, 2, leaky=True), tl.ResCNRStack(12, 2, leaky=True),
             _x((2, 16, 12), 1), convert.convert_audio_encoder, seed=1)


@pytest.mark.parametrize("residual,cin", [(False, 8), (True, 8), (True, 12)])
def test_cnr1d_layernorm(residual, cin):
    _compare(jl.CNR1d(12, norm="ln", residual=residual),
             tl.CNR1d(cin, 12, residual=residual),
             _x((2, 16, cin), 2), convert.convert_face, seed=2)


@pytest.mark.parametrize("t_in,t_out", [(50, 30), (17, 40), (9, 9)])
def test_linear_interpolate(t_in, t_out):
    x = _x((2, t_in, 3), 3)
    ref = np.asarray(jl.linear_interpolate(jnp.asarray(x), t_out))
    out = tl.linear_interpolate(torch.as_tensor(x), t_out).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_vq_decoder_decode_latents():
    jm = jv.VQVAE(in_dim=39, embedding_dim=16, num_hiddens=32)
    state = jvq.init_vq_state(jax.random.PRNGKey(1), 64, 16)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 39)), state), 4)
    idx = np.random.default_rng(4).integers(0, 64, (2, 6)).astype(np.int32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(idx), state,
                              method=jv.VQVAE.decode_latents))
    tm = tv.VQVAE(39, embedding_dim=16, num_hiddens=32).eval()
    tm.load_state_dict(convert.convert_vqvae(variables))
    tstate = tvq.VQState(*(torch.tensor(np.asarray(a)) for a in state))
    with torch.no_grad():
        out = tm.decode_latents(torch.as_tensor(idx).long(), tstate).numpy()
    assert out.shape == ref.shape == (2, 24, 39)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_audio_encoder():
    _compare(jv.AudioEncoder(num_hiddens=64), tv.AudioEncoder(64, num_hiddens=64),
             _x((2, 32, 64), 5), convert.convert_audio_encoder, seed=5)

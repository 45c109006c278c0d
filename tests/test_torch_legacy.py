"""The layer zoo (talkshow_torch/models/layers.py: UNet1D, SeqEncoder1D,
SeqDecoder1D, SeqTranslatorRNN) and the legacy S2G family
(talkshow_torch/models/s2g_legacy.py: FreeformS2G, S2GDiscriminator)
against the JAX package on the CPU, weights through `convert`, in eval
mode (running statistics) and train mode (batch statistics, the running
ones updated), at toy widths.

Tolerance 1e-5 on outputs and updated statistics (the same f32 math summed
in another order).  Train-mode randomness is JAX's own: the template and
VAE noise drawn with jax.random from the keys FreeformS2G uses
(talkshow_tpu/models/s2g_legacy.py:104-113, 59-63), the dropout masks read
from flax's Dropout by an interceptor, all handed to the port as `noise`.
Odd lengths exercise flax's max_pool floor, the repeat + resize of
UNet1D's up path and the discriminator's TF-"SAME" right padding."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from talkshow_tpu.models import layers as jl
from talkshow_tpu.models import s2g_legacy as js
from talkshow_torch import convert
from talkshow_torch.models import layers as tl
from talkshow_torch.models import s2g_legacy as ts

torch.set_num_threads(2)
TOL = 1e-5


def _randomize(variables, seed):
    """Perturb every leaf; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _close(got, want, tag, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (tag, err)


def _stats_close(port: torch.nn.Module, jax_stats, convert_fn, tag):
    want = convert_fn({"batch_stats": jax.tree.map(np.asarray, jax_stats)})
    sd = port.state_dict()
    assert want, tag
    for k, v in want.items():
        _close(sd[k], v, f"{tag} {k}")


ZOO = {
    # name: (flax module, port module, input shape)
    "unet": (lambda: jl.UNet1D(channels=8, out_channels=5),
             lambda: tl.UNet1D(16, 8, 5), (2, 33, 16)),
    "seq_encoder": (lambda: jl.SeqEncoder1D(hidden=16, out_dim=7),
                    lambda: tl.SeqEncoder1D(16, 16, 7), (2, 33, 16)),
    "seq_decoder": (lambda: jl.SeqDecoder1D(hidden=16, out_channels=4, length=20),
                    lambda: tl.SeqDecoder1D(7, 16, 4, 20), (2, 7)),
    "seq_translator_rnn": (lambda: jl.SeqTranslatorRNN(hidden=16, out_channels=5),
                           lambda: tl.SeqTranslatorRNN(8, 16, 5), (2, 12, 8)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(ZOO))
def test_layer_zoo_matches_flax(name, train):
    make_j, make_t, shape = ZOO[name]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jm = make_j()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = make_t()
    port.load_state_dict(convert.convert_layer_zoo(jax.tree.map(np.asarray, variables)))
    port.train(train)
    if train:
        want, upd = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x))
    got = port(torch.as_tensor(x))
    _close(got, want, name)
    if train:
        _stats_close(port, upd["batch_stats"], convert.convert_layer_zoo, name)


def test_gru_bias_layout_and_causality():
    """The converted GRU keeps b_hh's r and z thirds at zero through a
    backward step, and an output frame depends on frames <= t only."""
    port = tl.SeqTranslatorRNN(8, 16, 5)
    H = 16
    opt = torch.optim.SGD(port.parameters(), lr=0.1)
    port(torch.randn(2, 12, 8)).square().sum().backward()
    opt.step()
    assert torch.count_nonzero(port.gru.bias_hh_l0[: 2 * H]) == 0
    assert torch.count_nonzero(port.gru.bias_hh_l0[2 * H:]) > 0
    port.eval()
    x = torch.randn(1, 12, 8)
    y = port(x)
    x2 = x.clone()
    x2[0, -1] += 1.0
    # the front end's k3 conv reaches one frame back: frames < T - 2 are untouched
    torch.testing.assert_close(port(x2)[0, :-2], y[0, :-2], rtol=0, atol=0)


class _Drops:
    """Records each flax Dropout call's keep mask by module path."""

    def __init__(self):
        self.keep = {}

    def __call__(self, next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            x = np.asarray(args[0])
            self.keep["/".join(context.module.scope.path)] = (np.asarray(out) != 0) | (x == 0)
        return out


S2G = dict(pose_dim=275, each_dim=(3, 113, 90, 69), template_length=16, common_dim=64)


def _s2g_pair(seed=0, B=2, T=32):
    jm = js.FreeformS2G(**S2G)
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((B, T, 64)).astype(np.float32)
    gt = (0.3 * rng.standard_normal((B, T, 275))).astype(np.float32)
    variables = jax.jit(lambda s, g: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(4)}, s, g, True,
        jax.random.PRNGKey(1)))(jnp.asarray(spec), jnp.asarray(gt))
    variables = _randomize(variables, 2)
    port = ts.FreeformS2G(64, **S2G)
    port.load_state_dict(convert.convert_s2g(jax.tree.map(np.asarray, variables)))
    return jm, variables, port, spec, gt


@pytest.mark.parametrize("keyed", [False, True], ids=["zero_template", "noise_template"])
def test_freeform_s2g_eval_matches_flax(keyed):
    jm, variables, port, spec, _ = _s2g_pair()
    key = jax.random.PRNGKey(3) if keyed else None
    out, template, mu, lv = jax.jit(lambda v, x: jm.apply(v, x, None, False, key))(
        variables, jnp.asarray(spec))
    noise = None
    if keyed:   # the template JAX drew (s2g_legacy.py:110-112)
        noise = {"template": torch.as_tensor(np.array(
            jax.random.normal(key, (2, 32, S2G["template_length"]))))}
    got = port.eval()(torch.as_tensor(spec), noise=noise)
    _close(got[0], out, "out")
    _close(got[1], template, "template")
    assert mu is None and got[2] is None and got[3] is None


def test_freeform_s2g_train_matches_flax():
    """Train mode with poses: the template from the pose posterior, the
    audio VAE's sample, both encoders' dropout, batch statistics.

    B = 4, T = 64: the UNets' last stride-2 block leaves T / 32 frames, and
    its batch statistics over B x T / 32 values are ill-conditioned at
    B = 2, T = 32 (2 values a channel), where JAX's own f32 output lies
    1.0e-3 and the port's 9.2e-4 from the port run in f64 on the same
    draws; here 2.4e-5 and 1.7e-5."""
    B, T = 4, 64
    jm, variables, port, spec, gt = _s2g_pair(5, B, T)
    key = jax.random.PRNGKey(7)
    drops = _Drops()
    with fnn.intercept_methods(drops):
        (out, template, mu, lv), upd = jm.apply(
            variables, jnp.asarray(spec), jnp.asarray(gt), True, key,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(9)})
    tlen = S2G["template_length"]
    noise = {
        "template": torch.as_tensor(np.array(jax.random.normal(key, (B, T, tlen)))),
        "audio_eps": torch.as_tensor(np.array(
            jax.random.normal(jax.random.fold_in(key, 1), (B, T, 128)))),
        "drop_audio": torch.as_tensor(next(v for k, v in drops.keep.items()
                                           if k.startswith("audio_encoder"))),
        "drop_speech": torch.as_tensor(next(v for k, v in drops.keep.items()
                                            if k.startswith("speech_encoder"))),
    }
    assert len(drops.keep) == 2
    got = port.train()(torch.as_tensor(spec), torch.as_tensor(gt), noise=noise)
    for g, w, tag in zip(got, (out, template, mu, lv), ("out", "template", "mu", "log_var")):
        _close(g, w, tag)
    _stats_close(port, upd["batch_stats"], convert.convert_s2g, "FreeformS2G")


def test_freeform_s2g_train_draws_from_a_generator():
    """A generator stands in for the injected draws: finite, the shapes of
    JAX's, and two runs from one seed equal."""
    _, _, port, spec, gt = _s2g_pair()
    port.train()
    runs = [port(torch.as_tensor(spec), torch.as_tensor(gt),
                 noise=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert runs[0][0].shape == (2, 32, 275) and torch.isfinite(runs[0][0]).all()
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        port(torch.as_tensor(spec), torch.as_tensor(gt))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_s2g_discriminator_matches_flax(train):
    x = np.random.default_rng(6).standard_normal((2, 61, 275)).astype(np.float32)
    jm = js.S2GDiscriminator()
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    port = ts.S2GDiscriminator(275)
    port.load_state_dict(convert.convert_s2g(jax.tree.map(np.asarray, variables)))
    port.train(train)
    if train:
        want, upd = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x))
    _close(port(torch.as_tensor(x)), want, "discriminator")
    if train:
        _stats_close(port, upd["batch_stats"], convert.convert_s2g, "discriminator")


@pytest.mark.parametrize("length,kernel,stride", [(60, 4, 2), (61, 4, 2), (61, 4, 1), (7, 3, 3)])
def test_same_pad_matches_lax(length, kernel, stride):
    want = jax.lax.padtype_to_pads((length,), (kernel,), (stride,), "SAME")[0]
    assert ts.same_pad(length, kernel, stride) == tuple(want)

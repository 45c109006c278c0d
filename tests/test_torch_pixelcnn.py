"""Port PixelCNN prior and its AR decode against the JAX package.

* the teacher-forced forward matches flax to atol 1e-4;
* the plain sampler reproduces JAX `sample_tokens` tokens bit for bit when
  both get JAX's own gumbel block (free run and with a prefix);
* the K1 wrapper runs the plain version for CPU tensors;
* the kernel's packed tables and buffer layout, run through a transcription
  of the op list the CUDA code builds for each row (same offsets and
  strides, in dependency order), reproduce the plain sampler — the CUDA
  code itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models.pixelcnn import GatedPixelCNN as JPixelCNN
from talkshow_tpu.models.pixelcnn import sample_tokens as jax_sample_tokens
from talkshow_torch.convert import convert_pixelcnn
from talkshow_torch.kernels import counts
from talkshow_torch.kernels.ar_decode import (conditioning, pack_decode_tables,
                                              round_like_tables, sample_tokens_fused)
from talkshow_torch.models.pixelcnn import GatedPixelCNN, sample_tokens

torch.set_num_threads(2)

K, DIM, LAYERS, CLASSES, AUDC = 32, 16, 4, 4, 8
B, H = 3, 7


@pytest.fixture(scope="module")
def models():
    jm = JPixelCNN(input_dim=K, dim=DIM, n_layers=LAYERS, n_classes=CLASSES,
                   audio=True, bh_model=True, audio_channels=AUDC)
    jv = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 9, 2), jnp.int32),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 9, AUDC)))
    # non-zero biases so every bias path is exercised
    jv = jax.tree.map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)),
                      jv)
    tm = GatedPixelCNN(input_dim=K, dim=DIM, n_layers=LAYERS, n_classes=CLASSES,
                       audio_channels=AUDC).eval()
    tm.load_state_dict(convert_pixelcnn(jax.tree.map(np.asarray, jv)))
    return jm, jv, tm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, CLASSES, (B,)).astype(np.int32)
    audio = rng.standard_normal((B, H, AUDC)).astype(np.float32)
    tokens = rng.integers(0, K, (B, H, 2)).astype(np.int32)
    return label, audio, tokens


def _jax_noise(key):
    """The JAX sampler's own gumbel block (pixelcnn.py:306-315)."""
    keys01 = jax.vmap(jax.random.split)(jax.random.split(key, H))
    return np.array(jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (B, K))))(keys01))


def test_teacher_forced_forward_matches_flax(models):
    jm, jv, tm = models
    label, audio, tokens = _inputs()
    ref = np.asarray(jm.apply(jv, jnp.asarray(tokens), jnp.asarray(label),
                              jnp.asarray(audio)))
    with torch.no_grad():
        out = tm(torch.as_tensor(tokens).long(), torch.as_tensor(label).long(),
                 torch.as_tensor(audio)).numpy()
    assert out.shape == (B, H, 2, K)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("prefix_len", [0, 3])
def test_plain_sampler_tokens_bitwise_equal_jax(models, prefix_len):
    jm, jv, tm = models
    label, audio, given = _inputs(1)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_sample_tokens(
        jm, jv, jnp.asarray(label), jnp.asarray(audio), key,
        prefix_tokens=jnp.asarray(given), prefix_len=prefix_len))
    out = sample_tokens(tm, torch.as_tensor(label).long(), torch.as_tensor(audio),
                        noise=torch.as_tensor(_jax_noise(key)),
                        prefix_tokens=torch.as_tensor(given).long(),
                        prefix_len=prefix_len)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy()[:, :prefix_len], given[:, :prefix_len])


def test_plain_sampler_logits_equal_teacher_forced_forward(models):
    _, _, tm = models
    label, audio, given = _inputs(2)
    lab, aud, tok = (torch.as_tensor(label).long(), torch.as_tensor(audio),
                     torch.as_tensor(given).long())
    out, logits = sample_tokens(tm, lab, aud, generator=torch.Generator().manual_seed(0),
                                prefix_tokens=tok, prefix_len=H, return_logits=True)
    with torch.no_grad():
        ref = tm(tok, lab, aud)
    np.testing.assert_array_equal(out.numpy(), given)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu(models):
    _, _, tm = models
    label, audio, _ = _inputs(3)
    noise = torch.as_tensor(np.random.default_rng(3).gumbel(size=(H, 2, B, K)),
                            dtype=torch.float32)
    counts.clear()
    got = sample_tokens_fused(tm, torch.as_tensor(label).long(), torch.as_tensor(audio),
                              noise=noise)
    assert counts["sample_tokens_plain"] == 1 and counts["ar_decode"] == 0
    want = sample_tokens(tm, torch.as_tensor(label).long(), torch.as_tensor(audio),
                         noise=noise)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# Transcription of the ops csrc/ar_decode.cu lists for each row (row_ops),
# over flat f32 buffers with the kernel's pointer offsets and strides, run in
# dependency order, so the table packing and buffer layout are checked on
# the CPU.
# ---------------------------------------------------------------------------

def _view(buf, off, shape, strides):
    return buf.as_strided(shape, strides, off)


def _lin(w, w_off, w_ld, k0, klen, x, x_off, x_ld, nb, nout, y, y_off, y_ld,
         bias=None, add=None, add_off=0, add_ld=0, relu=False, roll_off=None):
    acc = _view(x, x_off, (nb, klen), (x_ld, 1)) @ _view(w, w_off + k0, (nout, klen), (w_ld, 1)).T
    if bias is not None:
        acc = acc + bias
    if add is not None:
        acc = acc + _view(add, add_off, (nb, nout), (add_ld, 1))
    if relu:
        acc = acc.clamp_min(0)
    if roll_off is not None:
        _view(y, roll_off, (nb, nout), (y_ld, 1)).copy_(_view(y, y_off, (nb, nout), (y_ld, 1)))
    _view(y, y_off, (nb, nout), (y_ld, 1)).copy_(acc)


def _gated(w, w_off, w_ld, k0, klen, x, x_off, x_ld, nb, half, bias=None, add=None,
           add_off=0, add_ld=0, pre=None, pre_off=0, pre_ld=0, cls=None, cls_off=0,
           out=None, out_off=0, out_ld=0, roll_off=None):
    xv = _view(x, x_off, (nb, klen), (x_ld, 1))
    a = xv @ _view(w, w_off + k0, (half, klen), (w_ld, 1)).T
    c = xv @ _view(w, w_off + half * w_ld + k0, (half, klen), (w_ld, 1)).T
    if bias is not None:
        a, c = a + bias[:half], c + bias[half:]
    if add is not None:
        a = a + _view(add, add_off, (nb, half), (add_ld, 1))
        c = c + _view(add, add_off + half, (nb, half), (add_ld, 1))
    if pre is not None:
        _view(pre, pre_off, (nb, half), (pre_ld, 1)).copy_(a)
        _view(pre, pre_off + half, (nb, half), (pre_ld, 1)).copy_(c)
    if out is None:
        return
    a = a + _view(cls, cls_off, (nb, half), (2 * half, 1))
    c = c + _view(cls, cls_off + half, (nb, half), (2 * half, 1))
    if roll_off is not None:
        _view(out, roll_off, (nb, half), (out_ld, 1)).copy_(_view(out, out_off, (nb, half), (out_ld, 1)))
    _view(out, out_off, (nb, half), (out_ld, 1)).copy_(torch.tanh(a) * torch.sigmoid(c))


def _emulate_decode(t, cls, audv, audh, noise, Bn, Hn, L, d, Kn, hid):
    f = {k: v.float().reshape(-1) for k, v in t.items()}
    cls, audv, audh = cls.reshape(-1), audv.reshape(-1), audh.reshape(-1)
    d2, d4 = 2 * d, 4 * d
    sizes = [Bn * 6 * d, (L - 1) * Bn * d4, Bn * d2, L * Bn * d4, L * Bn * d4,
             (L + 1) * Bn * d2, Bn * d2, Bn * d, Bn * hid, Bn * Kn]
    buf = torch.zeros(sum(sizes))
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    ehist, xs, xv0, hv, v2h, xh, xh0, g, hidb, lg = offs
    tokens = torch.zeros((Bn, Hn, 2), dtype=torch.long)
    logits = torch.zeros((Bn, Hn, 2, Kn))
    for row in range(Hn):
        for c in range(2):    # layer 0 vertical, per column group
            _gated(f["wv0"], c * d2 * 6 * d, 6 * d, 0, 6 * d, buf, ehist, 6 * d, Bn, d,
                   bias=f["bv"][:d2], pre=buf, pre_off=hv + c * d2, pre_ld=d4,
                   cls=cls, out=buf, out_off=xv0 + c * d, out_ld=d2)
        for c in range(2):    # fusion_v into layer-1 current row
            _lin(f["wfv"], 0, d, 0, d, buf, xv0 + c * d, d2, Bn, d, buf,
                 xs + d + c * d2, d4, add=audv, add_off=row * d, add_ld=Hn * d,
                 roll_off=xs + c * d2)
        for l in range(1, L):
            for c in range(2):
                kw = {}
                if l < L - 1:
                    kw = dict(cls=cls, cls_off=l * Bn * d2, out=buf,
                              out_off=xs + l * Bn * d4 + d + c * d2, out_ld=d4,
                              roll_off=xs + l * Bn * d4 + c * d2)
                _gated(f["wvB"], (l - 1) * 2 * d2 * d4 + c * d2 * d4, d4, 0, d4, buf,
                       xs + (l - 1) * Bn * d4, d4, Bn, d, bias=f["bv"][l * d2:(l + 1) * d2],
                       pre=buf, pre_off=hv + l * Bn * d4 + c * d2, pre_ld=d4, **kw)
        for l in range(L):
            for c in range(2):
                _lin(f["wv2h"], l * d2 * d2, d2, 0, d2, buf, hv + l * Bn * d4 + c * d2, d4,
                     Bn, d2, buf, v2h + l * Bn * d4 + c * d2, d4)
        for c in range(2):
            for l in range(L):
                k0, klen = (d, 0 if l == 0 else d) if c == 0 else (0, d if l == 0 else d2)
                _gated(f["wh"], l * d2 * d2, d2, k0, klen, buf, xh + l * Bn * d2, d2, Bn, d,
                       bias=f["bhsum"][l * d2:(l + 1) * d2], add=buf,
                       add_off=v2h + l * Bn * d4 + c * d2, add_ld=d4, cls=cls,
                       cls_off=l * Bn * d2, out=buf, out_off=g, out_ld=d)
                y_off = (xh0 if l == 0 else xh + (l + 1) * Bn * d2) + c * d
                _lin(f["wres"], l * d * d, d, 0, d, buf, g, d, Bn, d, buf, y_off, d2,
                     bias=f["br"][l * d:(l + 1) * d],
                     add=buf if l > 0 else None, add_off=xh + l * Bn * d2 + c * d, add_ld=d2)
                if l == 0:
                    _lin(f["wfh"], 0, d, 0, d, buf, xh0 + c * d, d2, Bn, d, buf,
                         xh + Bn * d2 + c * d, d2, add=audh, add_off=row * d, add_ld=Hn * d)
            _lin(f["w1"], 0, d, 0, d, buf, xh + L * Bn * d2 + c * d, d2, Bn, hid, buf, hidb,
                 hid, bias=f["b1"], relu=True)
            _lin(f["w2"], 0, hid, 0, hid, buf, hidb, hid, Bn, Kn, buf, lg, Kn, bias=f["b2"])
            z = _view(buf, lg, (Bn, Kn), (Kn, 1))
            logits[:, row, c] = z
            tok = torch.argmax(z + noise[row, c], dim=-1)
            tokens[:, row, c] = tok
            emb = f["emb"].reshape(Kn, d)
            if c == 0:
                _view(buf, xh, (Bn, d), (d2, 1)).copy_(emb[tok])
            else:
                h = _view(buf, ehist, (Bn, 2, 3, d), (6 * d, 3 * d, d, 1))
                h[:, :, :2] = h[:, :, 1:].clone()
                h[:, :, 2] = emb[tokens[:, row]]
    return tokens, logits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_tables_reproduce_plain_sampler(models, dtype):
    _, _, tm = models
    label, audio, _ = _inputs(4)
    lab, aud = torch.as_tensor(label).long(), torch.as_tensor(audio)
    noise = torch.as_tensor(np.random.default_rng(4).gumbel(size=(H, 2, B, K)),
                            dtype=torch.float32)
    tables = pack_decode_tables(tm, dtype)
    tm = round_like_tables(tm, dtype)   # the plain side gets the same rounded weights
    cls, audv, audh = conditioning(tm, lab, aud)
    with torch.no_grad():
        tok, logits = _emulate_decode(tables, cls, audv, audh, noise, B, H, LAYERS,
                                      DIM, K, tm.out_hidden.out_features)
    want, want_logits = sample_tokens(tm, lab, aud, noise=noise, return_logits=True)
    np.testing.assert_array_equal(tok.numpy(), want.numpy())
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-4)

"""The full-width parity receipt: the port against the JAX package at the
widths the released models use, with random weights, on the CPU (slow:
minutes of XLA compile and f32 work, so `-m slow` only):

  * wav2vec 2.0 base with the face heads (FaceGenerator) on 1 s of audio;
  * the body and hand VQ-VAEs at 1024 hidden with 2048 x 64 codebooks on 16
    frames (encode, quantize, decode);
  * the 256 x 15 prior and the 6-D variant's 512 x 10 prior over 2048 codes:
    the teacher-forced logits, and the plain sampler against JAX's
    `sample_tokens` under JAX's own gumbel noise.

Small inputs keep the memory to a few GB; the widths are the models'.
Tolerances, relative to each output's largest magnitude (the same f32 math
summed in another order, through 12 or 15 layers): 1e-4 for the face
stage and the VQ round trip, 1e-4 for the logits; indices equal where the
best and second-best code distances differ by more than 1e-5 (1 + |best|);
sampled tokens equal up to the first near-tie (the two top scores within
1e-3 of each other), after which an autoregressive draw may go either
way."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.models.face import FaceGenerator as JFace
from talkshow_tpu.models.pixelcnn import GatedPixelCNN as JPixelCNN
from talkshow_tpu.models.pixelcnn import sample_tokens as jax_sample_tokens
from talkshow_tpu.models.vqvae import VQVAE as JVQVAE
from talkshow_tpu.ops import vq as jvq
from talkshow_torch import convert
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.pixelcnn import GatedPixelCNN, sample_tokens
from talkshow_torch.models.vqvae import VQVAE
from talkshow_torch.ops.vq import VQState

pytestmark = pytest.mark.slow
TOL = 1e-4


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1e-12, np.abs(want).max()))


def _perturb(tree, seed, scale=0.02):
    """Non-zero biases and norm offsets, so every path carries signal."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


def test_face_stage_wav2vec_base():
    wav = (0.1 * np.random.default_rng(0).standard_normal((1, 16000))).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[2]]
    jm = JFace()
    args = (jnp.asarray(wav), jnp.asarray(onehot))
    v = _perturb(jax.jit(lambda w, i: jm.init(jax.random.PRNGKey(0), w, i, 30))(*args), 1)
    want = np.asarray(jax.jit(lambda vv, w, i: jm.apply(vv, w, i, 30))(v, *args))
    tm = FaceGenerator().eval()
    tm.load_state_dict(convert.convert_face(v))
    with torch.no_grad():
        got = tm(torch.as_tensor(wav), torch.as_tensor(onehot), 30).numpy()
    assert got.shape == (1, 30, 103)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("in_dim", [39, 90], ids=["body", "hand"])
def test_vqvae_1024_hidden_2048_codes(in_dim):
    poses = (0.3 * np.random.default_rng(in_dim).standard_normal((1, 16, in_dim))) \
        .astype(np.float32)
    jm = JVQVAE(in_dim=in_dim, num_hiddens=1024)
    st = jvq.init_vq_state(jax.random.PRNGKey(3), 2048, 64)
    v = _perturb(jax.jit(lambda p: jm.init(jax.random.PRNGKey(0), p, st))(jnp.asarray(poses)), 2)
    z = np.asarray(jax.jit(lambda vv, p: jm.apply(vv, p, method=lambda m, x: m.encoder(x)))(
        v, jnp.asarray(poses)))
    _, idx = jax.jit(lambda vv, p: jm.apply(vv, p, st, method=JVQVAE.encode))(
        v, jnp.asarray(poses))
    idx = np.asarray(idx)
    recon = np.asarray(jax.jit(lambda vv, i: jm.apply(vv, i, st, method=JVQVAE.decode_latents))(
        v, jnp.asarray(idx)))
    tm = VQVAE(in_dim, 64, 1024).eval()
    tm.load_state_dict(convert.convert_vqvae(jax.tree.map(np.asarray, v)))
    tst = VQState(*(torch.tensor(np.asarray(a)) for a in st))
    with torch.no_grad():
        tz = tm.encoder(torch.as_tensor(poses))
        _, tidx = tm.encode(torch.as_tensor(poses), tst)
        trecon = tm.decode_latents(torch.as_tensor(idx).long(), tst)
    assert _rel_err(tz.numpy(), z) <= TOL
    emb = np.asarray(st.embeddings, np.float64)
    d = ((z.reshape(-1, 64)[:, None, :].astype(np.float64) - emb[None]) ** 2).sum(-1)
    best = np.sort(d, axis=1)
    clear = best[:, 1] - best[:, 0] > 1e-5 * (1 + np.abs(best[:, 0]))
    np.testing.assert_array_equal(tidx.numpy().reshape(-1)[clear], idx.reshape(-1)[clear])
    assert _rel_err(trecon.numpy(), recon) <= TOL


@pytest.mark.parametrize("dim,layers", [(256, 15), (512, 10)], ids=["3d_256x15", "6d_512x10"])
def test_prior_at_full_width(dim, layers):
    K, H, B = 2048, 8, 1
    rng = np.random.default_rng(dim)
    label = np.asarray([1], np.int32)
    audio = rng.standard_normal((B, H, 256)).astype(np.float32)
    tokens = rng.integers(0, K, (B, H, 2)).astype(np.int32)
    jm = JPixelCNN(input_dim=K, dim=dim, n_layers=layers)
    args = (jnp.asarray(tokens), jnp.asarray(label), jnp.asarray(audio))
    v = _perturb(jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(*args), 4, 0.01)
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    tm = GatedPixelCNN(input_dim=K, dim=dim, n_layers=layers).eval()
    tm.load_state_dict(convert.convert_pixelcnn(jax.tree.map(np.asarray, v)))
    with torch.no_grad():
        got = tm(torch.as_tensor(tokens).long(), torch.as_tensor(label).long(),
                 torch.as_tensor(audio)).numpy()
    assert _rel_err(got, want) <= TOL

    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax_sample_tokens(jm, v, jnp.asarray(label), jnp.asarray(audio), key))
    keys01 = jax.vmap(jax.random.split)(jax.random.split(key, H))
    noise = np.array(jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (B, K))))(keys01))
    out, logits = sample_tokens(tm, torch.as_tensor(label).long(), torch.as_tensor(audio),
                                noise=torch.as_tensor(noise), return_logits=True)
    out, scores = out.numpy(), logits.numpy() + noise.transpose(2, 0, 1, 3)
    for h in range(H):
        for c in range(2):
            if out[0, h, c] == ref[0, h, c]:
                continue
            top = np.sort(scores[0, h, c])[-2:]
            assert top[1] - top[0] <= 1e-3, (h, c, top)
            return      # the draws may diverge from a near-tie on

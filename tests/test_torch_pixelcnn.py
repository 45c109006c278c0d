"""Port PixelCNN prior and its AR decode against the JAX package.

* the teacher-forced forward matches flax to atol 1e-4;
* the plain sampler reproduces JAX `sample_tokens` tokens bit for bit when
  both get JAX's own gumbel block (free run and with a prefix);
* the K1 wrapper runs the plain version for CPU tensors;
* the kernel's packed tables and its work, transcribed as tasks of its two
  roles (the vertical group's phases; the chain cluster's steps per CTA,
  reading the weight streams through the part descriptors and the
  previous step's outputs from every CTA's slice), reproduce the plain
  sampler in order and in any random order that keeps only the waits the
  kernel declares, and lose it when one of those waits is dropped — the
  CUDA code itself runs only on the card (tests/test_torch_kernels_cuda.py).
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
# Transcription of csrc/ar_decode.cu as tasks of its two roles.  Vertical
# group: one task per (row, phase), in the phases the kernel's host code
# forms.  Chain cluster: one task per (row, step, CTA q) that gathers the
# step's input from every CTA's slice, reads CTA q's rows of the weight
# stream through the part descriptors and writes CTA q's slice; then one
# row-end task per CTA (column 1's sample, tokens, its slice of the
# embedding history, "row sampled").  Each task lists the waits the kernel
# declares: program order and the group barrier inside the vertical group,
# the cluster barrier after every chain step, v2h[l] of the row before
# column 0's gated step l, and "row r-1 sampled" before vertical layer 0.
# ---------------------------------------------------------------------------

GATED, RESID, FUSION, HIDDEN, LOGITS = range(5)


def _gate(pre, cls):
    d = pre.shape[-1] // 2
    return torch.tanh(pre[..., :d] + cls[..., :d]) * torch.sigmoid(pre[..., d:] + cls[..., d:])


class _Decode:
    def __init__(self, tables, cls, audv, audh, noise, prefix=None, prefix_len=0):
        f = {k: v.float() for k, v in tables.items() if k != "parts"}
        self.f, self.cls, self.audv, self.audh, self.noise = f, cls, audv, audh, noise
        self.steps = []
        for part in tables["parts"].tolist():
            if part[7] & 1:
                self.steps.append([])
            self.steps[-1].append(part)
        self.C = f["chain"].shape[0]
        L, B, d2 = cls.shape
        d, H, K, hid = d2 // 2, audv.shape[1], f["b2"].shape[0], f["b1"].shape[0]
        self.L, self.B, self.d, self.H, self.K = L, B, d, H, K
        self.n, self.hn, self.kn = d // self.C, hid // self.C, K // self.C
        self.prefix, self.prefix_len = prefix, prefix_len if prefix is not None else 0
        self.ehist = torch.zeros(B, 2, 3, d)
        self.xs = torch.zeros(L - 1, B, 2, 2, d)
        self.xv0 = torch.zeros(B, 2, d)
        self.hv = torch.zeros(L, B, 2, 2 * d)
        self.v2h = torch.zeros(L, B, 2, 2 * d)
        self.cta = [dict(hist0=torch.zeros(L + 1, B, self.n), xh1=torch.zeros(B, self.n),
                         gs=torch.zeros(B, self.n), tmp=torch.zeros(B, self.n),
                         hid=torch.zeros(B, self.hn), cval=torch.zeros(B),
                         cidx=torch.zeros(B, dtype=torch.long),
                         tokh=torch.full((3, B, 2), -1, dtype=torch.long))
                    for _ in range(self.C)]
        self.tokens = torch.zeros((B, H, 2), dtype=torch.long)
        self.logits = torch.zeros((B, H, 2, K))
        # vertical phases: layer 0 | fusion_v, v2h 0 | layer 1 | layer l, v2h l-1 | v2h L-1
        self.phases = ([[("layer", 0)], [("fusion", 0), ("v2h", 0)]]
                       + [[("layer", l)] + ([("v2h", l - 1)] if l > 1 else []) for l in range(1, L)]
                       + [[("v2h", L - 1)]])
        self.v2h_phase = {op[1]: p for p, ops in enumerate(self.phases) for op in ops if op[0] == "v2h"}

    # -- vertical group ------------------------------------------------------
    def vertical(self, row, p):
        f, B, d = self.f, self.B, self.d
        for kind, l in self.phases[p]:
            if kind == "layer":
                x = (self.ehist if l == 0 else self.xs[l - 1]).reshape(B, -1)
                w = f["wv0"] if l == 0 else f["wvB"][l - 1]
                for c in (0, 1):
                    pre = x @ w[c].T + f["bv"][l]
                    self.hv[l, :, c] = pre
                    if l == 0:
                        self.xv0[:, c] = _gate(pre, self.cls[0])
                    elif l < self.L - 1:
                        self.xs[l, :, c, 0] = self.xs[l, :, c, 1]
                        self.xs[l, :, c, 1] = _gate(pre, self.cls[l])
            elif kind == "fusion":
                for c in (0, 1):
                    self.xs[0, :, c, 0] = self.xs[0, :, c, 1]
                    self.xs[0, :, c, 1] = self.xv0[:, c] @ f["wfv"].T + self.audv[:, row]
            else:
                for c in (0, 1):
                    self.v2h[l, :, c] = self.hv[l, :, c] @ f["wv2h"][l].T

    # -- chain cluster -------------------------------------------------------
    def gather(self, name, layer=None):
        return torch.cat([s[name] if layer is None else s[name][layer] for s in self.cta], dim=1)

    def sample(self, q, col, row):
        me = self.cta[q]
        if row < self.prefix_len:
            tok = self.prefix[:, row, col].long()
        else:
            best, tok = self.cta[0]["cval"].clone(), self.cta[0]["cidx"].clone()
            for s in self.cta[1:]:
                take = (s["cval"] > best) | ((s["cval"] == best) & (s["cidx"] < tok))
                best, tok = torch.where(take, s["cval"], best), torch.where(take, s["cidx"], tok)
        me["tokh"][2, :, col] = tok

    def chain_step(self, row, s, q):
        f, me, B, d, L = self.f, self.cta[q], self.B, self.d, self.L
        kind, col, layer = self.steps[s][0][:3]
        x = None
        if kind == GATED:
            if col == 0:
                x = self.gather("hist0", layer) if layer > 0 else None
            elif layer == 0:
                self.sample(q, 0, row)
                x = f["emb"][me["tokh"][2, :, 0]]
            else:
                x = torch.cat([self.gather("hist0", layer), self.gather("xh1")], dim=1)
        elif kind == RESID:
            x = self.gather("gs")
        elif kind == FUSION:
            x = self.gather("tmp")
        elif kind == HIDDEN:
            x = self.gather("hist0", L) if col == 0 else self.gather("xh1")
        else:
            x = self.gather("hid")
            best, bi = torch.full((B,), -float("inf")), torch.full((B,), 2 ** 31 - 1)
        for _, _, _, klen, u0, nu, off, _ in self.steps[s]:
            urows = 2 if kind == GATED else 1
            w = f["chain"][q, off:off + nu * urows * klen].reshape(nu * urows, klen)
            acc = x @ w.T if klen else torch.zeros(B, nu * urows)
            u = torch.arange(u0, u0 + nu)
            if kind == GATED:
                j = q * self.n + u
                v2h, cls = self.v2h[layer, :, col], self.cls[layer]
                a = acc[:, 0::2] + (f["bhsum"][layer, j] + v2h[:, j]) + cls[:, j]
                c = acc[:, 1::2] + (f["bhsum"][layer, j + d] + v2h[:, j + d]) + cls[:, j + d]
                me["gs"][:, u] = torch.tanh(a) * torch.sigmoid(c)
            elif kind == RESID:
                o = q * self.n + u
                own = me["hist0"][layer] if col == 0 else me["xh1"]
                extra = f["br"][layer, o] + (own[:, u] if layer > 0 else 0.0)
                y = me["tmp"] if layer == 0 else me["hist0"][layer + 1] if col == 0 else me["xh1"]
                y[:, u] = acc + extra
            elif kind == FUSION:
                y = me["hist0"][1] if col == 0 else me["xh1"]
                y[:, u] = acc + self.audh[:, row, q * self.n + u]
            elif kind == HIDDEN:
                me["hid"][:, u] = (acc + f["b1"][q * self.hn + u]).clamp_min(0)
            else:
                o = q * self.kn + u
                z = acc + f["b2"][o]
                self.logits[:, row, col, o] = z
                zz = z + self.noise[row, col][:, o]
                m, i = zz.max(dim=1)
                i = (zz == m[:, None]).int().argmax(dim=1) + o[0]   # the first maximum
                take = (m > best) | ((m == best) & (i < bi))
                best, bi = torch.where(take, m, best), torch.where(take, i, bi)
        if kind == LOGITS:
            me["cval"], me["cidx"] = best, bi

    def row_end(self, row, q):
        me, n, d = self.cta[q], self.n, self.d
        self.sample(q, 1, row)
        if q == 0:
            self.tokens[:, row] = me["tokh"][2]
        sl = slice(q * n, (q + 1) * n)
        for r in range(3):
            for c in (0, 1):
                tok = me["tokh"][r, :, c]
                e = self.f["emb"][tok.clamp_min(0), sl] * (tok >= 0)[:, None]
                self.ehist[:, c, r, sl] = e
        me["tokh"][:2] = me["tokh"][1:].clone()

    # -- the tasks and their declared waits -----------------------------------
    def tasks(self, drop=None):
        """{task: (run, [tasks it waits for])}, in program order."""
        C, nph, ns = self.C, len(self.phases), len(self.steps)
        out = {}
        for row in range(self.H):
            for p in range(nph):
                deps = [("V", row, p - 1)] if p else []
                if p == 0 and row > 0:
                    deps.append(("V", row - 1, nph - 1))
                    if drop != "row":
                        deps += [("E", row - 1, q) for q in range(C)]
                out[("V", row, p)] = (lambda row=row, p=p: self.vertical(row, p), deps)
            for s, parts in enumerate(self.steps):
                kind, col, layer = parts[0][:3]
                for q in range(C):
                    if s:
                        deps = [("S", row, s - 1, r) for r in range(C)]   # cluster barrier
                    else:
                        deps = [("E", row - 1, q)] if row else []
                    if kind == GATED and col == 0 and drop != "v2h":
                        deps.append(("V", row, self.v2h_phase[layer]))
                    out[("S", row, s, q)] = (lambda row=row, s=s, q=q: self.chain_step(row, s, q),
                                             deps)
            for q in range(C):
                out[("E", row, q)] = (lambda row=row, q=q: self.row_end(row, q),
                                      [("S", row, ns - 1, r) for r in range(C)])
        return out

    def run(self, order_seed=None, drop=None):
        """Run every task once; the next is the first ready one in program
        order, or a random ready one drawn from `order_seed`."""
        tasks = self.tasks(drop)
        rng = None if order_seed is None else np.random.default_rng(order_seed)
        waits = {t: set(deps) for t, (_, deps) in tasks.items()}
        users = {t: [] for t in tasks}
        for t, deps in waits.items():
            for dep in deps:
                users[dep].append(t)
        ready = [t for t in tasks if not waits[t]]
        while ready:
            t = ready.pop(0 if rng is None else int(rng.integers(len(ready))))
            tasks[t][0]()
            for u in users[t]:
                waits[u].discard(t)
                if not waits[u]:
                    ready.append(u)
        assert not any(waits.values()), "the declared waits deadlock"
        return self.tokens, self.logits


def _decode_case(models, dtype, prefix_len=0, seed=4):
    _, _, tm = models
    label, audio, given = _inputs(seed)
    lab, aud = torch.as_tensor(label).long(), torch.as_tensor(audio)
    noise = torch.as_tensor(np.random.default_rng(seed).gumbel(size=(H, 2, B, K)),
                            dtype=torch.float32)
    prefix = torch.as_tensor(given).long() if prefix_len else None
    tables = pack_decode_tables(tm, dtype)
    tm = round_like_tables(tm, dtype)   # the plain side gets the same rounded weights
    cls, audv, audh = conditioning(tm, lab, aud)
    emu = _Decode(tables, cls, audv, audh, noise, prefix, prefix_len)
    want = sample_tokens(tm, lab, aud, noise=noise, prefix_tokens=prefix,
                         prefix_len=prefix_len, return_logits=True)
    return emu, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_tables_reproduce_plain_sampler(models, dtype):
    emu, (want, want_logits) = _decode_case(models, dtype)
    with torch.no_grad():
        tok, logits = emu.run()
    np.testing.assert_array_equal(tok.numpy(), want.numpy())
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-4)


@pytest.mark.parametrize("order_seed", [0, 1, 2, 3])
def test_declared_waits_suffice_in_any_order(models, order_seed):
    emu, (want, want_logits) = _decode_case(models, torch.bfloat16)
    with torch.no_grad():
        tok, logits = emu.run(order_seed)
    np.testing.assert_array_equal(tok.numpy(), want.numpy())
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-4)


@pytest.mark.parametrize("drop", ["v2h", "row"])
def test_dropping_a_declared_wait_breaks_some_order(models, drop):
    emu, (_, want_logits) = _decode_case(models, torch.float32)
    with torch.no_grad():
        _, logits = emu.run(order_seed=5, drop=drop)
    assert (logits - want_logits).abs().max().item() > 1e-2


@pytest.mark.parametrize("order_seed", [8, 16])
def test_prefix_shorter_than_h(models, order_seed):
    emu, (want, want_logits) = _decode_case(models, torch.float32, prefix_len=3, seed=6)
    with torch.no_grad():
        tok, logits = emu.run(order_seed=order_seed)
    np.testing.assert_array_equal(tok.numpy(), want.numpy())
    np.testing.assert_array_equal(tok.numpy()[:, :3], _inputs(6)[2][:, :3])
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-4)


@pytest.mark.parametrize("widths", [dict(dim=24), dict(input_dim=40), dict(hidden=72)],
                         ids=["dim", "codebook", "head"])
def test_widths_must_divide_among_the_chain_cluster(widths):
    """Each of the chain's 16 CTAs owns an equal slice of every step."""
    kw = dict(input_dim=K, dim=DIM, n_layers=2, n_classes=CLASSES, audio_channels=AUDC)
    with pytest.raises(ValueError):
        pack_decode_tables(GatedPixelCNN(**{**kw, **widths}), torch.float32)


def test_chain_parts_cover_each_cta_stream_once(models):
    """The part descriptors tile every step's rows of a CTA's stream in
    order, parts stay within PART_BYTES and the stream ends on a chunk."""
    from talkshow_torch.kernels import ar_decode as k1
    tm = models[2]
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.empty((), dtype=dtype).element_size()
        parts, row_elems = k1.chain_parts(LAYERS, DIM, K, tm.out_hidden.out_features, esize)
        off = 0
        for kind, _, _, klen, _, nu, p_off, _ in parts:
            size = nu * klen * (2 if kind == k1.GATED else 1)
            assert p_off == off and size * esize <= k1.PART_BYTES and (p_off * esize) % 32 == 0
            off += size
        assert off <= row_elems and (row_elems * esize) % k1.CHUNK_BYTES == 0
        assert row_elems - off < k1.CHUNK_BYTES // esize

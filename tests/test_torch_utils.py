"""talkshow_torch/utils.py against talkshow_tpu/utils.py on the CPU:
seeding, `cast_floats` (which tensors stay f32, and the
generate path on a bf16-cast prior and audio encoder against JAX's
test_extras.py:230 on the same weights and noise, within 1e-4: both sides
compute in f32 on the bf16-rounded weights), the trace context, and the
trainer's `prefetch_iter` re-exported."""
import copy
import os

import numpy as np
import pytest
import torch

from talkshow_tpu import pipeline as jpipe
from talkshow_tpu import utils as jutils
from talkshow_torch import tracing
from talkshow_torch import utils as U
from talkshow_torch.kernels.ar_decode import pack_decode_tables
from talkshow_torch.models.vqvae import AudioEncoder
from talkshow_torch.train import trainer
from test_torch_harness import BODY, jax_noise, pipeline_pair

torch.set_num_threads(2)


def test_seed_everything_is_deterministic():
    (r1, g1), (r2, g2) = U.seed_everything(42), U.seed_everything(42)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))
    # the numpy stream is JAX's (both are np.random.default_rng(seed))
    assert U.seed_everything(7)[0].integers(1 << 30) == jutils.seed_everything(7)[0].integers(
        1 << 30)


def test_prefetch_iter_is_the_trainers():
    assert U.prefetch_iter is trainer.prefetch_iter
    assert list(U.prefetch_iter(iter(range(50)), depth=3)) == list(range(50))

    def boom():
        yield 1
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for x in U.prefetch_iter(boom()):
            got.append(x)
    assert got == [1]


def test_cast_floats_keeps_norms_f32():
    enc = AudioEncoder(num_hiddens=32)
    sd = U.cast_floats(enc.state_dict())
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.int64
        elif ".norm." in k:
            assert v.dtype == torch.float32, k
        else:
            assert v.dtype == torch.bfloat16, k
    assert U.cast_floats(enc.state_dict(), keep_norm_f32=False)["project.norm.weight"].dtype \
        == torch.bfloat16
    U.cast_floats(enc)
    assert enc.project.conv.weight.dtype == torch.bfloat16
    assert enc.project.norm.running_var.dtype == torch.float32


def test_cast_floats_generate_body_matches_jax():
    """JAX's test_extras.py:230 on the port: generate_body with the prior and
    the audio encoder cast to bf16 (norms f32) equals JAX's on the same
    weights and noise; K1's tables pack from a prior whose parameters are
    bf16 tensors bit for bit as from the f32 one holding their values."""
    jp, tp = pipeline_pair(4)
    body = jp.body._replace(prior_vars=jutils.cast_floats(jp.body.prior_vars),
                            audio_enc_vars=jutils.cast_floats(jp.body.audio_enc_vars))
    jp16 = jpipe.Pipeline(jp.face_model, jp.face_vars, body)
    for m in (tp.body.prior, tp.body.audio_enc):
        m.load_state_dict(U.cast_floats(m.state_dict()))
    feat = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    want = np.asarray(jp16.generate_body(feat, 0))
    noise = torch.as_tensor(jax_noise(0, 4, 1, BODY["code_num"]))
    got = tp.generate_body(feat, 0, noise=noise)
    assert got.shape == want.shape == (1, 16, 129) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    prior16 = U.cast_floats(copy.deepcopy(tp.body.prior))
    assert prior16.embedding.weight.dtype == torch.bfloat16
    a, b = pack_decode_tables(prior16), pack_decode_tables(tp.body.prior)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_trace_writes_a_chrome_trace(tmp_path):
    with U.trace(str(tmp_path)) as prof:
        with tracing.span("region"):
            torch.ones(4).sum()
    assert prof is not None and os.path.isfile(tmp_path / "trace.json")
    assert '"span:region"' in open(tmp_path / "trace.json").read()
    with U.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")

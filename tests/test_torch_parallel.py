"""The port's multi-device layer (talkshow_torch/parallel, the sharded
sampling of pipeline.py and serving.py, the trainer's config.parallel)
against the JAX package on the CPU, whose tests run on 8 virtual devices.

- `param_spec` splits exactly the tensors JAX's `_param_spec` shards, on
  the 512-hidden VQ-VAE, a prior over 512 codes and the face model at the
  widths of tests/test_torch_parallel_face.py (tp 2 and 4; names matched
  through `talkshow_torch.convert`: each flax leaf is 1 where JAX shards
  it): wav2vec's out_proj, FFN, feature projection, positional conv and
  first extractor conv, never its q / k / v projections.
- `make_mesh` / `global_mesh` raise where JAX's do.
- `generate_body_sharded` on a (dp 4, tp 2) mesh of CPU devices, fed JAX's
  per-shard gumbel blocks (shard i: split(PRNGKey(seed), 4)[i]): tokens
  bit-equal to JAX's shards, conv within 1e-5; ValueError at 6 samples.
- The mesh `MotionServer` against JAX's mesh server: face columns within
  2e-4 (JAX's own test's bound for its sharded server); with JAX's
  per-shard noise (shard i: keys[i * B_local] of split(key, B)) every
  column within 1e-4 (the serving tests' motion bound); a flush
  reproduces per seed; ValueError at max_batch 3.
- `Trainer` with config.parallel dp * tp > 1 and no process group raises,
  naming torchrun.  A face batch whose rows do not split over dp raises
  ValueError: whole clips under dp 2 at `setup`, a bucket's 3-row batch in
  `device_batch`, as JAX's device_put of such a batch raises.  (The face
  step on a mesh itself: tests/test_torch_parallel_face.py.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from talkshow_tpu.models import pixelcnn as jpix
from talkshow_tpu.models import vqvae as jv
from talkshow_tpu.models.body import generate_conv_poses as jgenerate
from talkshow_tpu.parallel import mesh as jmesh
from talkshow_tpu.parallel import multihost as jmh
from talkshow_tpu.serving import MotionServer as JMotionServer
from talkshow_tpu.ops.vq import init_vq_state as jinit_vq
from talkshow_torch import convert
from talkshow_torch.config import body_vq_config
from talkshow_torch.data.dataset import synthetic_dataset
from talkshow_torch.kernels import counts
from talkshow_torch.models.pixelcnn import GatedPixelCNN
from talkshow_torch.models.vqvae import VQVAE
from talkshow_torch.parallel import multihost
from talkshow_torch.parallel.mesh import make_mesh, param_spec
from talkshow_torch.serving import MotionServer
from talkshow_torch.train.steps import make_body_vq_step
from talkshow_torch.train.trainer import Trainer
from test_torch_harness import K, jax_noise_from_key, pipeline_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipes():
    return pipeline_pair(0)


def _jax_split_tree(params, tp=2):
    """The flax params with each leaf 1 where JAX's rule shards it on tp."""
    def leaf(path, x):
        keys = tuple(str(k.key) for k in path)
        return np.full(x.shape, 1.0 if jmesh._param_spec(keys, x, tp) != P() else 0.0,
                       np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _assert_same_split(module, split_sd):
    split = {name for name, t in split_sd.items() if t.numel() and bool((t == 1).all())}
    assert split, "JAX shards nothing here"
    ours = {name for name, p in module.named_parameters() if param_spec(name, p, 2)}
    assert ours == split


def test_param_spec_matches_jax_on_the_vqvae():
    jm = jv.VQVAE(in_dim=39, num_hiddens=512)
    st = jinit_vq(jax.random.PRNGKey(0), 2048, 64)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 39)), st)
    split = convert.convert_vqvae({"params": _jax_split_tree(variables["params"])})
    _assert_same_split(VQVAE(39, 64, 512), split)
    # the transposed convolution splits on its input channels, as JAX's
    # ConvTranspose kernel (k, out, in) does on its last axis
    assert "decoder._up_2.conv.weight" in {k for k, v in split.items() if bool((v == 1).all())}


def test_param_spec_matches_jax_on_a_prior():
    jm = jpix.GatedPixelCNN(input_dim=512, dim=16, n_layers=3, n_classes=4, audio=True)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 2), jnp.int32),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 256)))
    split = convert.convert_pixelcnn({"params": _jax_split_tree(variables["params"])})
    _assert_same_split(GatedPixelCNN(input_dim=512, dim=16, n_layers=3), split)
    assert {"embedding.weight", "out_hidden.weight", "out_logits.weight"} <= set(
        k for k, v in split.items() if bool((v == 1).all()))


@pytest.mark.parametrize("tp", [2, 4])
def test_param_spec_matches_jax_on_the_face_model(tp):
    from talkshow_tpu.models import face as jface
    from talkshow_tpu.models import wav2vec as jw2v
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    from torch_dist_check import FACE_WIDTHS
    cfg = FACE_WIDTHS["toy"]["cfg"]
    jm = jface.FaceGenerator(wav2vec_cfg=jw2v.Wav2Vec2Config(**cfg))
    variables = jax.jit(jm.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.zeros((1, 16000)),
                                                    jnp.zeros((1, 4)), 30)

    def leaf(path, x):
        keys = tuple(str(k.key) for k in path)
        return np.full(x.shape, 1.0 if jmesh._param_spec(keys, x, tp) != P() else 0.0,
                       np.float32)

    split_sd = convert.convert_face({"params": jax.tree_util.tree_map_with_path(
        leaf, variables["params"])})
    split = {name for name, t in split_sd.items() if t.numel() and bool((t == 1).all())}
    module = FaceGenerator(Wav2Vec2Config(**cfg))
    assert {name for name, p in module.named_parameters() if param_spec(name, p, tp)} == split
    enc = "audio_encoder.encoder."
    assert {enc + "pos_conv_embed.conv.weight", enc + "layers.0.attention.out_proj.weight",
            enc + "layers.1.feed_forward.intermediate_dense.weight",
            "audio_encoder.feature_extractor.conv_layers.0.conv.weight",
            "audio_encoder.feature_projection.projection.weight"} <= split
    assert not any(n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight")) for n in split)


def test_meshes_raise_where_jax_raises(monkeypatch):
    cpus = [torch.device("cpu")] * 8
    for dp, tp in ((3, 2), (None, 3), (4, 4)):
        with pytest.raises(ValueError):
            jmesh.make_mesh(dp=dp, tp=tp)
        with pytest.raises(ValueError):
            make_mesh(dp=dp, tp=tp, devices=cpus)
    mesh = make_mesh(dp=4, tp=2, devices=cpus)
    assert mesh.shape == jmesh.make_mesh(dp=4, tp=2).shape == {"dp": 4, "tp": 2}
    assert mesh.axis_names == ("dp", "tp")
    with pytest.raises(ValueError):
        jmh.global_mesh(dp=3, tp=2)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.global_mesh(dp=3, tp=2)
    # tp may not leave a host: 8 ranks, 4 to a host
    monkeypatch.setattr(multihost, "world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="cross hosts"):
        multihost.global_mesh(dp=1, tp=8)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize_multihost("127.0.0.1:1", 2, 0, backend=None)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="a card per rank"):
            multihost.initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl")


def test_generate_body_sharded_matches_jax(pipes):
    jp, tp = pipes
    jm = jmesh.make_mesh(dp=4, tp=2)
    mesh = make_mesh(dp=4, tp=2, devices=[torch.device("cpu")] * 8)
    feat = np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)
    S, seed, H = 8, 3, 24 // 4
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    noise = [torch.as_tensor(jax_noise_from_key(k, H, S // 4, K)) for k in keys]
    want = jp.generate_body_sharded(feat, speaker=1, num_samples=S, mesh=jm, seed=seed)
    # JAX's shard i: generate_conv_poses on its rows with keys[i]
    jtokens = []
    for i in range(4):
        f = jnp.asarray(feat)[None].repeat(S // 4, 0)
        ids = jnp.full((S // 4,), 1, jnp.int32)
        _, tok = jgenerate(jp.body._replace(**jp._body_arrays), f, ids, keys[i],
                           tables=jp._decode_tables)
        jtokens.append(np.asarray(tok))
    counts.clear()
    parts = tp.generate_conv_sharded(feat, 1, S, mesh, seed, noise=noise)
    assert counts["sample_tokens_plain"] == 4           # one decode per shard
    for (_, tok), jt in zip(parts, jtokens):
        np.testing.assert_array_equal(tok.numpy(), jt)
    got = tp.generate_body_sharded(feat, 1, S, mesh, seed, noise=noise)
    assert got.shape == want.shape == (S, 24, 129)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # without noise: seeded per shard, reproducible, diverse across shards
    a = tp.generate_body_sharded(feat, 1, S, mesh, seed)
    np.testing.assert_array_equal(a, tp.generate_body_sharded(feat, 1, S, mesh, seed))
    assert np.abs(a[0] - a[4]).max() > 1e-6
    with pytest.raises(ValueError):
        tp.generate_body_sharded(feat, 1, 6, mesh)


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(int(16000 * seconds)) * 0.1 * 32768.0)
    return (np.clip(x, -32768, 32767) / 32768.0).astype(np.float32)


def jax_shard_noise(max_batch, shards):
    """JAX's mesh server: shard i decodes with keys[i * B_local] of
    split(fold_in(fold_in(PRNGKey(base), bucket), index), max_batch)."""
    b = max_batch // shards

    def noise(base, bucket, index, rows):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(base), bucket), index)
        keys = jax.random.split(key, max_batch)
        return torch.as_tensor(np.concatenate(
            [jax_noise_from_key(keys[i * b], rows, b, K) for i in range(shards)], axis=2))
    return noise


def test_mesh_server_matches_jax(pipes):
    jp, tp = pipes
    jm = jmesh.make_mesh(dp=4, tp=2)
    mesh = make_mesh(dp=4, tp=2, devices=[torch.device("cpu")] * 8)
    js = JMotionServer(jp, bucket_frames=16, max_batch=4, mesh=jm)
    ts = MotionServer(tp, bucket_frames=16, max_batch=4, mesh=mesh,
                      noise=jax_shard_noise(4, 4))
    plain = MotionServer(tp, bucket_frames=16, max_batch=4)
    seeded = MotionServer(tp, bucket_frames=16, max_batch=4, mesh=mesh)
    wavs = [_wav(0.4, 20 + i) for i in range(4)]
    servers = (js, ts, plain, seeded)
    rids = [[s.submit(w, speaker=i % 4) for i, w in enumerate(wavs)] for s in servers]
    ref = js.flush(seed=11)
    counts.clear()
    outs = [s.flush(seed=11) for s in servers[1:]]
    # a group of 4 rows: one pass per shard, plain one pass
    assert counts["sample_tokens_plain"] == 4 + 1 + 4 and counts["face_plain"] == 9
    for j, a in enumerate(rids[0]):
        want = ref[a]
        for out, r in zip(outs, rids[1:]):
            got = out[r[j]]
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-4)
            np.testing.assert_allclose(got[:, -100:], want[:, -100:], atol=2e-4)
        np.testing.assert_allclose(outs[0][rids[1][j]], want, atol=1e-4)
    again = [seeded.submit(w, speaker=i % 4) for i, w in enumerate(wavs)]
    out2 = seeded.flush(seed=11)
    for b, b2 in zip(rids[3], again):
        np.testing.assert_array_equal(outs[2][b], out2[b2])
    with pytest.raises(ValueError):
        MotionServer(tp, max_batch=3, mesh=mesh)


def test_trainer_without_process_group_raises(tmp_path):
    cfg = body_vq_config()
    cfg.train.batch_size, cfg.data.pose.generate_length = 8, 16
    cfg.parallel.dp, cfg.parallel.tp = 4, 2
    ds = synthetic_dataset(num_clips=2, frames=100)
    ds.generate_length = 16
    init, step = make_body_vq_step(VQVAE(39, 64, 16), VQVAE(90, 64, 16), code_num=64)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 8"):
        Trainer(cfg, ds, init, step, run_dir=str(tmp_path / "run"), device="cpu").setup()


def test_face_batch_that_does_not_split_over_dp_raises(tmp_path):
    """Whole clips (one a batch) under dp 2 raise at `setup`, naming
    --face_bucket; a bucket's 3-row batch raises in `device_batch`
    (`batch_rows`); JAX's device_put of the same (1, N) batch over dp 2
    raises ValueError too."""
    from talkshow_torch.config import face_config
    from talkshow_torch.data.dataset import synthetic_face_dataset
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    from talkshow_torch.train.steps import make_face_step
    from test_torch_harness import TINY
    cfg = face_config()
    cfg.parallel.dp = 2
    ds = synthetic_face_dataset(num_clips=3, frames=30, bucketed=True)
    init, step = make_face_step(FaceGenerator(Wav2Vec2Config(**TINY)))
    mesh = make_mesh(dp=2, devices=[torch.device("cpu")] * 2)
    whole = Trainer(cfg, ds, init, step, run_dir=str(tmp_path / "whole"), device="cpu",
                    needs_rng=True, batch_mode="face_clips", mesh=mesh)
    with pytest.raises(ValueError, match="--face_bucket"):
        whole.setup()
    bucketed = Trainer(cfg, ds, init, step, run_dir=str(tmp_path / "bucketed"), device="cpu",
                       needs_rng=True, batch_mode="face_clips", face_bucket_frames=64,
                       face_batch_size=4, mesh=mesh).setup()
    batch = next(iter(bucketed.batch_iter(0)))
    assert batch["waveform"].shape[0] == 3 and "valid_frames" in batch
    with pytest.raises(ValueError, match="does not split over dp=2"):
        bucketed.device_batch(batch, [])
    clip = next(iter(synthetic_face_dataset(num_clips=1, frames=30).face_batches()))
    jm = jmesh.make_mesh(dp=2, tp=4)
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(jnp.asarray(clip["waveform"]), jmesh.batch_sharding(jm, 2))

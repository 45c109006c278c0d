"""The Adam steps' two kernels (talkshow_torch/csrc/adam.cu: grad_stats and
adam_apply) against their plain twin in talkshow_torch/kernels/adam.py, on
an NVIDIA GPU.  Imports no JAX, so it runs on a machine with the card and
PyTorch only:

    python -m pytest --noconftest tests/test_torch_adam_cuda.py -q

The leaf lists: those of the benchmark's train-prior-3d (the 3-D prior and
audio encoder, 198 leaves, 24.1 M elements) and train-vq-6d (the 6-D
VQ-VAEs, 212 leaves, 71.0 M) cells at full width, and a ragged list of
1500 leaves (more than one launch's table) of sizes 1 to 262 147, some of
them views 4 bytes off a 16-byte boundary (the kernels' scalar path).

Tolerances: the finite flag exactly; the global norm within 1e-5 of the
plain twin's (f32 sums of up to 71 M squares in another order), and bit for
bit over two calls; given the same norm, parameters and moments within 4
f32 ulps of the plain twin's, ulps of the largest of the new value, the old
and the change (the same operations in the same order, each rounded once,
but PyTorch's CUDA addcmul may fuse v's multiply-add, 1 ulp that reaches
the update through a square root and two divisions; where the update
cancels the old value, its own rounding is the error); a
non-finite step bit-equal in everything it must not write.
"""
import math

import pytest
import torch

import chip_smoke
from talkshow_torch.kernels import adam as adam_kernels
from talkshow_torch.kernels import counts

CELLS = ["train-prior-3d", "train-vq-6d", "ragged"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ragged(dev, seed=5):
    """1500 leaves of sizes 1 to 262 147; every seventh a view 4 bytes off
    a 16-byte boundary."""
    gen = torch.Generator().manual_seed(seed)
    sizes = [int(s) for s in torch.randint(1, 40, (1500,), generator=gen)]
    sizes[:6] = [1, 3, 4, 5, 65537, 4 * 65536 + 3]
    case = {k: [] for k in ("params", "grads", "exp_avgs", "exp_avg_sqs")}
    for i, n in enumerate(sizes):
        off = 1 if i % 7 == 3 else 0
        for k, scale in (("params", 0.05), ("grads", 1e-2), ("exp_avgs", 1e-4),
                         ("exp_avg_sqs", 1e-4)):
            x = scale * torch.randn(n, generator=gen)
            # a view `off` elements into its storage
            t = torch.empty(n + off, device=dev)[off:]
            case[k].append(t.copy_(x.square() if k == "exp_avg_sqs" else x))
    case["step"] = torch.full((), 3.0, device=dev)
    case["skipped"] = torch.ones((), dtype=torch.int64, device=dev)
    return case


def _case(cell, dev):
    if cell == "ragged":
        return _ragged(dev)
    return chip_smoke.adam_case(chip_smoke.adam_leaf_shapes(cell), dev, 18)


def test_kernels_raise_on_cpu_tensors():
    """The kernels have no CPU mode: CPU tensors raise, they never fall
    back (the dispatching `grad_stats` / `adam_apply` take the plain twin)."""
    g = [torch.ones(3)]
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernels.grad_stats_kernel(g, None)
    stats, finite = adam_kernels.grad_stats(g)
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernels.adam_apply_kernel([torch.ones(3)], g, [torch.zeros(3)], [torch.zeros(3)],
                                       stats, finite, torch.zeros(()),
                                       torch.zeros((), dtype=torch.int64), 1e-3, None)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("cell", CELLS)
def test_kernels_match_plain(cuda, cell, clip):
    case = _case(cell, cuda)
    n = len(case["params"])
    work = adam_kernels.workspace(n, cuda)
    cap_stats, cap_adam = adam_kernels.capacity()
    counts.clear()
    stats, finite = adam_kernels.grad_stats_kernel(case["grads"], work)
    plain, plain_finite = adam_kernels.grad_stats_plain(case["grads"])
    assert bool(finite) and bool(plain_finite)
    assert float((stats[1] - plain[1]).abs()) <= 1e-5 * float(plain[1])
    assert counts["grad_stats"] == math.ceil(n / cap_stats)
    # from the kernel's norm on both sides, so both take the same branch
    max_norm = 0.5 * float(stats[1]) if clip else 2.0 * float(stats[1])
    k, q = chip_smoke.adam_copy(case), chip_smoke.adam_copy(case)
    chip_smoke.adam_call(adam_kernels.adam_apply_kernel, k, stats, finite, max_norm, work=work)
    chip_smoke.adam_call(adam_kernels.adam_apply_plain, q, stats, finite, max_norm)
    assert counts["adam_apply"] == math.ceil(n / cap_adam)
    for key in ("params", "exp_avgs", "exp_avg_sqs"):
        assert chip_smoke.adam_gap(k[key], q[key], case[key]) <= chip_smoke.ADAM_ULPS, key
        assert not any(torch.equal(a, b) for a, b in zip(k[key][:8], case[key][:8])), key
    assert float(k["step"]) == float(q["step"]) == 4.0
    assert int(k["skipped"]) == int(q["skipped"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(k["grads"], case["grads"]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_kernels_repeat_bit_for_bit(cuda, cell):
    """Two calls from the same inputs: the same norm, flag, parameters and
    moments, bit for bit (a fixed grid, fixed sums, no float atomics)."""
    case = _case(cell, cuda)
    work = adam_kernels.workspace(len(case["params"]), cuda)
    runs = []
    for _ in range(2):
        stats, finite = adam_kernels.grad_stats_kernel(case["grads"], work)
        k = chip_smoke.adam_copy(case)
        chip_smoke.adam_call(adam_kernels.adam_apply_kernel, k, stats, finite,
                             0.5 * float(stats[1]), work=work)
        runs.append((stats, finite, k))
    (s0, f0, k0), (s1, f1, k1) = runs
    assert torch.equal(s0, s1) and torch.equal(f0, f1)
    for key in ("params", "exp_avgs", "exp_avg_sqs", "step", "skipped"):
        a, b = k0[key], k1[key]
        assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, list) \
            else torch.equal(a, b), key


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_nonfinite_element_skips_the_step(cuda, cell):
    """One NaN, or one inf, in one leaf's gradient: the flag is false and
    adam_apply writes nothing (parameters, moments and step count bit-equal)
    and counts the skip."""
    case = _case(cell, cuda)
    n = len(case["params"])
    work = adam_kernels.workspace(n, cuda)
    for value, leaf in ((float("nan"), n // 2), (float("inf"), n - 1)):
        bad = chip_smoke.adam_copy(case)
        bad["grads"][leaf].view(-1)[-1] = value
        before = chip_smoke.adam_copy(bad)
        stats, finite = adam_kernels.grad_stats_kernel(bad["grads"], work)
        assert not bool(finite)
        chip_smoke.adam_call(adam_kernels.adam_apply_kernel, bad, stats, finite, 1.0, work=work)
        for key in ("params", "exp_avgs", "exp_avg_sqs"):
            assert all(torch.equal(a, b) for a, b in zip(bad[key], before[key])), key
        assert float(bad["step"]) == 3.0 and int(bad["skipped"]) == 2


def _narrow_step(kind, dev):
    """A narrow pixel or VQ step on the card: its init state, step and batch."""
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    from talkshow_torch.ops import vq as vq_ops
    from talkshow_torch.train import steps
    gen = torch.Generator().manual_seed(3)
    vb, vh = VQVAE(39, 64, 16), VQVAE(90, 64, 16)
    B, T = 4, 16
    if kind == "vq":
        init, step = steps.make_body_vq_step(vb, vh, 1e-3, code_num=64)
        batch = {"poses": 0.2 * torch.randn((B, T, 165), generator=gen)}
    else:
        sts = {k: vq_ops.init_vq_state(gen, 64, 64, "cpu") for k in ("body", "hand")}
        init, step = steps.make_body_pixel_step(
            GatedPixelCNN(input_dim=64, dim=16, n_layers=3, audio_channels=32),
            AudioEncoder(num_hiddens=32), vb, vh, sts, 1e-3, 5.0)
        batch = {"aud_feat": torch.randn((B, T, 64), generator=gen),
                 "speaker": torch.arange(B), "tokens": torch.randint(0, 64, (B, T // 4, 2),
                                                                     generator=gen),
                 "aud_keep": torch.rand((B, T // 4), generator=gen) < 0.9}
    state = init(gen, dev)
    return state, step, {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pixel", "vq"])
def test_nonfinite_step_on_the_card_changes_nothing(cuda, kind):
    """A narrow pixel or VQ step on the card with one inf in one gradient
    element: parameters, moments, Adam's step count, every BatchNorm
    statistic (and the VQ states) bit-equal, the skip counted; each step
    launches each kernel once and reads nothing back (the VQ step's one
    host sync is its conv-channel index's copy to the card)."""
    state, step, batch = _narrow_step(kind, cuda)
    models = state.models
    opt = state.optimizer
    counts.clear()
    state, _ = step(state, batch)
    assert counts["grad_stats"] == counts["adam_apply"] == 1
    assert counts["host_sync"] == (1 if kind == "vq" else 0)
    flat = lambda: {f"{p}.{k}": v.clone() for p, m in models.items()   # noqa: E731
                    for k, v in m.state_dict().items()}
    before = flat()
    moments = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.adam.state.items()}
    vq_before = {k: [t.clone() for t in s] for k, s in getattr(state, "vq", {}).items()}
    leaf = next(next(iter(models.values())).parameters())
    hook = leaf.register_hook(lambda g: g.flatten().index_put(
        (torch.tensor([0], device=g.device),), torch.tensor(float("inf"), device=g.device)
    ).view_as(g))
    try:
        state, m = step(state, batch)
    finally:
        hook.remove()
    assert int(m["nonfinite_skips"]) == 1 and opt.nonfinite_count == 1
    after = flat()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    for p, s in opt.adam.state.items():
        assert all(torch.equal(v, moments[id(p)][k]) for k, v in s.items())
    for k, s in vq_before.items():
        assert all(torch.equal(a, b) for a, b in zip(state.vq[k], s)), k
    assert int(opt.step_count) == 1
    state, m = step(state, batch)
    assert int(opt.step_count) == 2 and int(m["nonfinite_skips"]) == 1

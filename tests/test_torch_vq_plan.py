"""K4's host plan and merge rule on the CPU (talkshow_torch/kernels/
nearest_code.py:search_plan, csrc/nearest_code.cu).

The CUDA kernel cannot run here, so what surrounds its arithmetic is held
in Python: the plan covers every row and code once and fits the card, and
a transcription of the kernel's selection (per thread a strict < over its
codes in ascending order, then the least 64-bit key of `pack_key` over the
thread's lanes, warps and the cluster's slices) equals torch.argmin of the
same distances and JAX's nearest_code_xla.  Exact comparisons: the
emulation reads the very distances it is compared on."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from talkshow_tpu.ops.vq import nearest_code_xla
from talkshow_torch.kernels.nearest_code import MAX_CLUSTER, TILES, code_norms, search_plan

SMEM_CAP = 227 * 1024       # shared memory a block can use on an H100


@pytest.mark.parametrize("K", [100, 2047, 2048])
@pytest.mark.parametrize("N", [1, 7, 75, 2816, 11264])
def test_search_plan_covers_each_row_and_code_once(N, K):
    p = search_plan(N, K, 64)
    rows, codes, _ = TILES[p.variant]
    assert p.rows == rows and 1 <= p.cluster <= MAX_CLUSTER and p.smem <= SMEM_CAP
    tiles = p.ctas // p.cluster
    assert tiles * p.cluster == p.ctas
    row_hits = np.zeros(N, int)
    for t in range(tiles):
        row_hits[t * p.rows:(t + 1) * p.rows] += 1
    code_hits = np.zeros(K, int)
    for q in range(p.cluster):
        lo, hi = q * p.slice, min(K, (q + 1) * p.slice)
        assert lo < hi                                   # no CTA without codes
        for k0 in range(lo, hi, codes):                  # the CTA's passes
            code_hits[k0:min(hi, k0 + codes)] += 1
        assert -(-(hi - lo) // codes) <= p.passes
    assert (row_hits == 1).all() and (code_hits == 1).all()


@pytest.mark.parametrize("N", [75, 2816])
def test_search_plan_fills_the_card(N):
    p = search_plan(N, 2048, 64)
    assert p.ctas >= 132 and p.passes <= 2
    assert search_plan(N, 2048, 16).smem < p.smem <= SMEM_CAP


def pack_key(dist: np.ndarray, code: np.ndarray) -> np.ndarray:
    """The kernel's pack_key: order-preserving bits of the f32 distance in
    the high word (-0.0 as +0.0), the code index in the low word."""
    b = np.where(dist == 0, np.float32(0), dist).astype(np.float32).view(np.uint32)
    b = np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint64)
    return (b << np.uint64(32)) | code.astype(np.uint64)


def kernel_pick(dist: np.ndarray) -> np.ndarray:
    """The kernel's selection over an (N, K) f32 distance matrix, thread by
    thread as its plan lays the codes out (D = 64)."""
    N, K = dist.shape
    p = search_plan(N, K, 64)
    _, codes, warps = TILES[p.variant]
    code_threads = 8 * warps                                 # a CTA's lanes across codes
    best = np.full(N, np.iinfo(np.uint64).max, np.uint64)
    for q in range(p.cluster):                               # the cluster's CTAs
        lo, hi = q * p.slice, min(K, (q + 1) * p.slice)
        for tc in range(code_threads):                       # a thread's code column
            bd = np.full(N, np.inf, np.float32)
            bk = np.full(N, lo, np.int64)
            for k0 in range(lo, hi, codes):                  # passes, then its codes
                for c in range(tc, min(codes, hi - k0), code_threads):
                    d = dist[:, k0 + c]
                    lt = d < bd
                    bd, bk = np.where(lt, d, bd), np.where(lt, k0 + c, bk)
            best = np.minimum(best, pack_key(bd, bk))        # lanes, warps, slices
    return (best & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _ties(rng, N, K):
    """Random distances with exact ties inside one slice and across slices,
    and -0.0 against +0.0 both ways round."""
    dist = rng.uniform(0.5, 2.0, (N, K)).astype(np.float32)
    p = search_plan(N, K, 64)
    s = p.slice
    dist[0, [3, s - 1]] = 0.25                      # one slice: 3 wins
    dist[1, [s + 5, 2 * s + 7, K - 1]] = -1.0       # three slices: s + 5 wins
    dist[2, [5, 300]] = [0.0, -0.0]                 # equal: 5 wins
    dist[3, [5, 300]] = [-0.0, 0.0]
    dist[4, [K - 2, K - 1]] = 0.1                   # the ragged last slice
    return dist


@pytest.mark.parametrize("N,K", [(75, 2047), (75, 2048), (2816, 2047), (7, 301)])
def test_kernel_merge_equals_argmin(N, K):
    dist = _ties(np.random.default_rng(N + K), N, K)
    got = kernel_pick(dist)
    want = torch.argmin(torch.as_tensor(dist), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5], [3, search_plan(N, K, 64).slice + 5, 5, 5, K - 2])


def test_pack_key_orders_negative_zero_as_zero():
    d = np.array([-1.0, -0.0, 0.0, 1e-30, 1.0, np.inf], np.float32)
    keys = pack_key(d, np.zeros(6, np.int64))
    assert keys[1] == keys[2]
    assert (np.diff(keys[[0, 2, 3, 4, 5]].astype(np.float64)) > 0).all()
    # without the rule, -0.0 would sort below +0.0 and take the higher index
    assert kernel_pick(np.array([[1.0, 0.0, -0.0]], np.float32))[0] == 1


@pytest.mark.parametrize("N,K", [(75, 2048), (300, 2047)])
def test_kernel_merge_equals_nearest_code_xla(N, K):
    """On the JAX package's own inputs: random rows and codes with one code
    duplicated into another CTA's slice, where the lower index must win."""
    rng = np.random.default_rng(N)
    x = (0.05 * rng.standard_normal((N, 64))).astype(np.float32)
    emb = rng.uniform(-0.05, 0.05, (K, 64)).astype(np.float32)
    emb[K - 1] = emb[11]
    x[0] = emb[11]
    want = np.asarray(nearest_code_xla(jnp.asarray(x), jnp.asarray(emb)))
    xt, et = torch.as_tensor(x), torch.as_tensor(emb)
    dist = (-2.0 * (xt @ et.T) + code_norms(et)[None, :]).numpy()   # nearest_code_plain's
    got = kernel_pick(dist)
    assert got[0] == 11 and (K - 1) // search_plan(N, K, 64).slice != 0
    np.testing.assert_array_equal(got, want)

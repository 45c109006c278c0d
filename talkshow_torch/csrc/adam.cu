// The Adam steps' optimizer chain as two multi-tensor passes, for Hopper:
// grad_stats (the non-finite check and the global norm of every gradient)
// and adam_apply (optax's clip by that norm, Adam(b1, b2, eps) with the
// bias corrections of a step count held on the device, parameters and
// moments written in place, nothing written on a non-finite step).
//
// Replaces no TPU kernel: the JAX step runs skip_nonfinite(chain(
// clip_by_global_norm, adam)) (talkshow_tpu/utils.py:75-114 around
// talkshow_tpu/train/steps.py:49,159-162) as optax's tree maps, which XLA
// fuses into the step's program.  Eager PyTorch launched a few kernels per
// leaf and read the flag and the norm on the host; here the whole chain is
// two launches (or one per table chunk, below) and no host read.
//
// What bounds it on the card: bytes.  grad_stats reads each gradient once
// (4 bytes an element), adam_apply reads the gradient, the parameter and the
// two moments and writes the last three (28 bytes an element): for the
// 3-D prior's 24.1 M elements 96 MB and 676 MB, ~29 us and ~0.20 ms at
// 3.35 TB/s.  Nothing is reused, so the design keeps every byte moving:
//
// - The leaf table (pointers and sizes) travels in the kernel's parameters
//   (__grid_constant__, up to 32 KB with CUDA 12.1), so the host copies
//   nothing to the card and waits for nothing; a list longer than one table
//   is cut into chunks, one launch each.
// - A fixed grid of kBlocks x kThreads threads walks every leaf in order;
//   a leaf's units (float4s where every pointer is 16-byte aligned, then
//   the tail elements) go to the threads in turn, starting where the last
//   leaf's left off (`rot`), so small leaves spread over the card instead
//   of piling onto block 0.
// - Sums have a fixed order: each thread adds its units in leaf order, the
//   block reduces by a fixed shuffle tree, writes its partial to its slot,
//   and the last block to finish (an integer ticket; no float atomics)
//   reduces the slots in slot order.  The grid never depends on the card,
//   so the norm, and the clip, repeat bit for bit.
// - adam_apply's last block also moves the step count (or, on a non-finite
//   step, the skip count): every block reads the count before it takes its
//   ticket, so none reads a count already moved.
// - The element arithmetic is the plain twin's (kernels/adam.py:
//   adam_apply_plain) with every rounding explicit (__f*_rn), the scalars
//   of the bias corrections in double as torch.optim.Adam takes them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;                    // resident at once: 64 registers a thread
constexpr int kBlocks = 132 * kBlocksPerSM;        // the whole grid resident on an H100 SXM
constexpr long long kStride = static_cast<long long>(kBlocks) * kThreads;
#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32000;                 // of the 32 764 CUDA 12.1 allows
#else
constexpr int kParamBytes = 4000;                  // of the classic 4 096
#endif

struct StatsLeaf {
  const float* g;
  long long n;
  int rot, vec;
};

struct AdamLeaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  int rot, vec;
};

// what precedes the leaves in a table: count, first slot, total slots
constexpr int kHead = 16;
constexpr int kStatsCap = (kParamBytes - kHead) / static_cast<int>(sizeof(StatsLeaf));
constexpr int kAdamCap = (kParamBytes - kHead - 64) / static_cast<int>(sizeof(AdamLeaf));

template <typename Leaf, int Cap>
struct Table {
  int count;   // leaves in this chunk
  int slot0;   // this launch's first partial slot
  int total;   // slots over every chunk of the call
  int pad;
  Leaf leaf[Cap];
};

using StatsTable = Table<StatsLeaf, kStatsCap>;
using AdamTable = Table<AdamLeaf, kAdamCap>;
static_assert(sizeof(StatsTable) <= kParamBytes && sizeof(AdamTable) + 64 <= kParamBytes,
              "a table has to fit in the kernel's parameters");

struct AdamScalars {
  const float* norm;      // the global norm (grad_stats' stats[1])
  const bool* finite;
  float* step;            // Adam's step count, f32 as torch keeps it
  long long* skipped;     // the non-finite count
  unsigned* ticket;
  double lr, max_norm, b1, b2, eps;   // max_norm < 0: no clip
};

// workspace: [stats ticket][adam ticket][pad][partial sums][partial flags]
struct Workspace {
  unsigned* stats_ticket;
  unsigned* adam_ticket;
  float* sums;
  unsigned* flags;
};

Workspace carve(void* base, int slots) {
  char* b = static_cast<char*>(base);
  Workspace w;
  w.stats_ticket = reinterpret_cast<unsigned*>(b);
  w.adam_ticket = reinterpret_cast<unsigned*>(b + 4);
  w.sums = reinterpret_cast<float*>(b + 16);
  w.flags = reinterpret_cast<unsigned*>(b + 16 + 4 * static_cast<size_t>(slots));
  return w;
}

__device__ __forceinline__ unsigned nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// the block's sum and flag, in a fixed order; valid in thread 0
__device__ __forceinline__ void block_reduce(float& s, unsigned& f) {
  __shared__ float ws[kThreads / 32];
  __shared__ unsigned wf[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    f |= __shfl_xor_sync(0xffffffffu, f, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ws[warp] = s;
    wf[warp] = f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = ws[0];
    f = wf[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      s = __fadd_rn(s, ws[w]);
      f |= wf[w];
    }
  }
}

// true in every thread of the block that finishes last over `total` blocks
__device__ __forceinline__ bool last_block(unsigned* ticket, int total) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(total - 1);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the first unit of a leaf that this thread takes
__device__ __forceinline__ long long first_unit(int rot) {
  long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - rot;
  return u < 0 ? u + kStride : u;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
grad_stats_kernel(const __grid_constant__ StatsTable t, Workspace w, float* stats, bool* finite) {
  float s = 0.f;
  unsigned f = 0;
  for (int i = 0; i < t.count; ++i) {
    const StatsLeaf& L = t.leaf[i];
    const long long n4 = L.vec ? L.n >> 2 : 0, units = n4 + (L.n - 4 * n4);
    long long u = first_unit(L.rot);
    const float4* g4 = reinterpret_cast<const float4*>(L.g);
    for (; u < n4; u += kStride) {
      const float4 x = __ldcs(g4 + u);
      s = __fmaf_rn(x.x, x.x, s);
      s = __fmaf_rn(x.y, x.y, s);
      s = __fmaf_rn(x.z, x.z, s);
      s = __fmaf_rn(x.w, x.w, s);
      f |= nonfinite(x.x) | nonfinite(x.y) | nonfinite(x.z) | nonfinite(x.w);
    }
    for (; u < units; u += kStride) {
      const float x = __ldcs(L.g + 4 * n4 + (u - n4));
      s = __fmaf_rn(x, x, s);
      f |= nonfinite(x);
    }
  }
  block_reduce(s, f);
  if (threadIdx.x == 0) {
    w.sums[t.slot0 + blockIdx.x] = s;
    w.flags[t.slot0 + blockIdx.x] = f;
  }
  if (!last_block(w.stats_ticket, t.total)) return;
  s = 0.f;
  f = 0;
  for (int k = threadIdx.x; k < t.total; k += kThreads) {
    s = __fadd_rn(s, __ldcg(w.sums + k));
    f |= __ldcg(w.flags + k);
  }
  __syncthreads();
  block_reduce(s, f);
  if (threadIdx.x == 0) {
    stats[0] = s;
    stats[1] = __fsqrt_rn(s);
    *finite = f == 0;
    *w.stats_ticket = 0;
  }
}

struct Consts {
  bool clip;
  float norm, max_norm, w1, b2, w2, eps, neg_step_size, bc2_sqrt;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Consts& c) {
  if (c.clip) g = __fmul_rn(__fdiv_rn(g, c.norm), c.max_norm);
  m = __fmaf_rn(c.w1, __fsub_rn(g, m), m);                                  // lerp(m, g, 1 - b1)
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(c.w2, g), g));      // v b2 + (1 - b2) g g
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), c.bc2_sqrt), c.eps);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(c.neg_step_size, m), denom));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
adam_apply_kernel(const __grid_constant__ AdamTable t, AdamScalars a) {
  const bool ok = *a.finite;
  const float step = *a.step + 1.f;
  if (ok) {
    __shared__ Consts sc;
    if (threadIdx.x == 0) {
      const float norm = *a.norm;
      const double bc1 = 1.0 - pow(a.b1, static_cast<double>(step));
      const double bc2 = 1.0 - pow(a.b2, static_cast<double>(step));
      sc.clip = a.max_norm >= 0 && !(norm < static_cast<float>(a.max_norm));
      sc.norm = norm;
      sc.max_norm = static_cast<float>(a.max_norm);
      sc.w1 = static_cast<float>(1.0 - a.b1);
      sc.b2 = static_cast<float>(a.b2);
      sc.w2 = static_cast<float>(1.0 - a.b2);
      sc.eps = static_cast<float>(a.eps);
      sc.neg_step_size = static_cast<float>(-(a.lr / bc1));
      sc.bc2_sqrt = static_cast<float>(sqrt(bc2));
    }
    __syncthreads();
    const Consts c = sc;
    for (int i = 0; i < t.count; ++i) {
      const AdamLeaf& L = t.leaf[i];
      const long long n4 = L.vec ? L.n >> 2 : 0, units = n4 + (L.n - 4 * n4);
      long long u = first_unit(L.rot);
      float4* p4 = reinterpret_cast<float4*>(L.p);
      float4* m4 = reinterpret_cast<float4*>(L.m);
      float4* v4 = reinterpret_cast<float4*>(L.v);
      const float4* g4 = reinterpret_cast<const float4*>(L.g);
      for (; u < n4; u += kStride) {
        float4 p = p4[u], m = m4[u], v = v4[u];
        const float4 g = __ldcs(g4 + u);
        adam_one(p.x, g.x, m.x, v.x, c);
        adam_one(p.y, g.y, m.y, v.y, c);
        adam_one(p.z, g.z, m.z, v.z, c);
        adam_one(p.w, g.w, m.w, v.w, c);
        p4[u] = p;
        m4[u] = m;
        v4[u] = v;
      }
      for (; u < units; u += kStride) {
        const long long e = 4 * n4 + (u - n4);
        adam_one(L.p[e], __ldcs(L.g + e), L.m[e], L.v[e], c);
      }
    }
  }
  if (!last_block(a.ticket, t.total)) return;
  if (threadIdx.x == 0) {
    if (ok)
      *a.step = step;
    else
      *a.skipped += 1;
    *a.ticket = 0;
  }
}

// the leaves' rotations and vector flags, over the whole list
template <typename Leaf>
void place(Leaf* out, int n, const long long* n_el, const uintptr_t* const* ptrs, int nptr,
           long long& rot) {
  for (int i = 0; i < n; ++i) {
    uintptr_t any = 0;
    for (int k = 0; k < nptr; ++k) any |= ptrs[k][i];
    out[i].n = n_el[i];
    out[i].vec = (any % 16) == 0;
    out[i].rot = static_cast<int>(rot);
    const long long units = out[i].vec ? n_el[i] / 4 + n_el[i] % 4 : n_el[i];
    rot = (rot + units) % kStride;
  }
}

struct DeviceGuard {
  int prev = -1, dev;
  explicit DeviceGuard(int d) : dev(d) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

int chunks(int n, int cap) { return n <= 0 ? 1 : (n + cap - 1) / cap; }

// partial slots of a call over n leaves: one per block of the longer call
int slots(int n) {
  const int a = chunks(n, kStatsCap), b = chunks(n, kAdamCap);
  return kBlocks * (a > b ? a : b);
}

}  // namespace

extern "C" {

// Leaves a launch of each kernel takes (kind 0: grad_stats, 1: adam_apply).
int talkshow_adam_capacity(int kind) { return kind == 0 ? kStatsCap : kAdamCap; }

// Bytes of the workspace a call over n leaves needs; zero-filled before its
// first use, and left zero-filled by every call that returns 0.
long long talkshow_adam_workspace_bytes(int n) {
  return 16 + 8LL * slots(n);
}

// stats[0] <- the sum of the squares of every element of the n gradients,
// stats[1] <- its square root, *finite <- no element is inf or nan.
// table: n rows of (pointer, elements), f32, contiguous, on `device`.
// *launches <- the kernels launched (one per kStatsCap leaves, at least
// one), on `stream`, without synchronising; returns the first
// cudaError_t, 0 on success.
int talkshow_grad_stats(int n, const long long* table, void* workspace, float* stats,
                        bool* finite, int* launches, int device, void* stream) {
  *launches = 0;
  if (n < 0 || !workspace || !stats || !finite) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const int total = kBlocks * chunks(n, kStatsCap);
  const Workspace w = carve(workspace, slots(n));
  long long rot = 0;
  for (int c = 0, i0 = 0; c < chunks(n, kStatsCap); ++c, i0 += kStatsCap) {
    StatsTable t{};
    t.count = n - i0 < kStatsCap ? n - i0 : kStatsCap;
    t.slot0 = c * kBlocks;
    t.total = total;
    long long n_el[kStatsCap];
    uintptr_t g[kStatsCap];
    for (int i = 0; i < t.count; ++i) {
      g[i] = static_cast<uintptr_t>(table[2 * (i0 + i)]);
      n_el[i] = table[2 * (i0 + i) + 1];
      t.leaf[i].g = reinterpret_cast<const float*>(g[i]);
    }
    const uintptr_t* ptrs[1] = {g};
    place(t.leaf, t.count, n_el, ptrs, 1, rot);
    grad_stats_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, w, stats,
                                                                                   finite);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

// One Adam step over n leaves, unless *finite is false: each gradient
// clipped by optax's rule against *norm when max_norm >= 0, then
// m <- lerp(m, g, 1 - b1), v <- v b2 + (1 - b2) g g, p <- p - lr / (1 -
// b1^t) m / (sqrt(v) / sqrt(1 - b2^t) + eps) with t = *step + 1, and *step
// <- t; on a non-finite step nothing of p, m, v or *step is written and
// *skipped goes up by one.  table: n rows of (p, g, m, v, elements), f32,
// contiguous, on `device`.  Launches as talkshow_grad_stats.
int talkshow_adam_apply(int n, const long long* table, void* workspace, const float* norm,
                        const bool* finite, float* step, long long* skipped, double lr,
                        double max_norm, double b1, double b2, double eps, int* launches,
                        int device, void* stream) {
  *launches = 0;
  if (n < 0 || !workspace || !norm || !finite || !step || !skipped)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const int total = kBlocks * chunks(n, kAdamCap);
  const Workspace w = carve(workspace, slots(n));
  const AdamScalars a{norm, finite, step, skipped, w.adam_ticket, lr, max_norm, b1, b2, eps};
  long long rot = 0;
  for (int c = 0, i0 = 0; c < chunks(n, kAdamCap); ++c, i0 += kAdamCap) {
    AdamTable t{};
    t.count = n - i0 < kAdamCap ? n - i0 : kAdamCap;
    t.slot0 = c * kBlocks;
    t.total = total;
    long long n_el[kAdamCap];
    uintptr_t cols[4][kAdamCap];
    for (int i = 0; i < t.count; ++i) {
      const long long* row = table + 5 * (i0 + i);
      for (int k = 0; k < 4; ++k) cols[k][i] = static_cast<uintptr_t>(row[k]);
      n_el[i] = row[4];
      t.leaf[i].p = reinterpret_cast<float*>(cols[0][i]);
      t.leaf[i].g = reinterpret_cast<const float*>(cols[1][i]);
      t.leaf[i].m = reinterpret_cast<float*>(cols[2][i]);
      t.leaf[i].v = reinterpret_cast<float*>(cols[3][i]);
    }
    const uintptr_t* ptrs[4] = {cols[0], cols[1], cols[2], cols[3]};
    place(t.leaf, t.count, n_el, ptrs, 4, rot);
    adam_apply_kernel<<<kBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // extern "C"

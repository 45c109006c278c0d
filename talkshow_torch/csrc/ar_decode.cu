// Fused autoregressive token decode of the Gated PixelCNN prior, for Hopper.
//
// Replaces the TPU kernel talkshow_tpu/models/pixelcnn_pallas.py:_sample_fused
// (:363, body _make_kernel :202-356): the whole decode of the (H, 2) [body,
// hand] token grid for B <= 32 samples, from one host call.  Per row: the 15
// gated vertical layers advance one row (layer 0 is mask A over 3 embedding
// rows), fusion_v after layer 0, v2h, the horizontal pass of column 0 (with
// fusion_h at layer 1 and the class-embedding bias), the ReLU head
// dim -> 512 -> K, gumbel-argmax (injected noise or in-kernel Philox), teacher
// forcing, then the same for column 1 seeded with column 0's embedding, and
// the embedding feedback into the history.
//
// What bounds it on the card: not bytes (~54 MB of bf16 tables per row,
// ~16 us at 3.35 TB/s) and not operations, but the ~70 dependent steps of a
// row: row r-1's tokens -> vertical layer 0 -> v2h -> column 0's 15 x (gated,
// resid) + fusion_h + head + sample -> column 1's same chain.  Every step is
// a GEMV with M = B <= 32, so what a step costs is its synchronisation and
// the latency of its loads, not its arithmetic.
//
// What the design does about it: one launch, every CTA resident, two roles.
// - The chain (everything after v2h: both horizontal passes, fusion_h, the
//   head, the gumbel-argmax, the embedding feedback) runs on ONE thread-block
//   cluster of C = 16 CTAs.  CTA q owns 1/C of each step's outputs and
//   keeps them in its shared memory; steps are separated by barrier.cluster
//   (arrive.release / wait.acquire), and the next step's input vector is
//   gathered from the CTAs' shared memory over distributed shared memory, not
//   through L2.  The argmax over K is a cluster reduction on (value, index),
//   ties to the lower index.
// - The chain's weights do not depend on the row state, so they arrive ahead
//   of need: the host lays each CTA's slices of every step out as one
//   contiguous stream per token row (`pack_decode_tables`), and a ring of
//   shared-memory stages is kept full with cp.async.bulk copies completing on
//   mbarriers, refilled as soon as a part of a step is consumed.  A step
//   computes from shared memory only.
// - The vertical stack, fusion_v and v2h run on the other CTAs as a list of
//   ops in dependency phases (one counter barrier over that group per phase),
//   with an L2 prefetch of the next phase's weights.  The roles meet through
//   flags only: the vertical group counts each layer's v2h done per row
//   (atom.add.release.gpu), the chain waits on it (ld.acquire.gpu) before
//   column 0's layer l; the chain counts "row r sampled" after writing the
//   tokens and the embedding history, and the vertical group waits on that
//   before layer 0 of row r+1.  State written by another CTA is read after
//   an acquire, never through the read-only path.
// - A step's products grow with B, so their layout follows it.  Up to 8
//   batch rows a warp's lanes split the batch rows and the row's k (each
//   weight chunk is read once and broadcast to the lanes of that chunk);
//   past 8, with bf16 tables, the chain's parts run on the tensor cores
//   (mma.sync m16n8k16 over 8 weight rows x 16 batch rows, x split into
//   bf16 hi + lo so the products keep 16 of x's bits), in a second
//   instantiation of the kernel that B <= 8 never loads; and the vertical
//   tasks take two output units each wherever that still leaves a task for
//   every warp.
// - Each step's fixed costs are kept off L2 where it can be: the part
//   descriptors, biases and (when they fit) the class embeddings and column
//   1's v2h sit in shared memory, and whether v2h[l + 1] is done is asked one
//   step ahead.  Shared memory leaves L1 ~26 KB, so the vertical group reads
//   its weights past L1 (no_allocate) and keeps L1 for the row state.
// Measured (PERF.md): ~3-4 us per chain step and ~6 us per vertical phase
// at B = 1, so the decode is still bound by its dependent steps; at B = 32
// the vertical group's phases (~22 us) pace column 0.
// Tables are bf16 (f32 for exact comparison), accumulation and all row state
// f32.  A spin that outlasts 20 s traps (a deadlock becomes a launch error).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;              // warps per CTA (one CTA per SM)
constexpr int kThreads = kWarps * 32;
constexpr int kBC = 4;                  // batch rows per vertical accumulator pass
constexpr int kMaxBatch = 32;           // one lane per batch row in the argmax
constexpr int kMaxStages = 32;
constexpr int kCluster = 16;            // CTAs of the chain's cluster
constexpr int kSmemCap = 227 * 1024;
constexpr unsigned long long kWatchdogNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void cvt8(const uint4 u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // bf16 -> f32: the high 16 bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cvt8(const float4 a, const float4 b, float v[8]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// read-only tables in global memory, read once per task: not kept in L1,
// which then holds the row state the tasks share
__device__ __forceinline__ uint4 ldg_na(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float4 f4(uint4 u) {
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z), __uint_as_float(u.w));
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  cvt8(f4(ldg_na(p)), f4(ldg_na(p + 4)), v);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  cvt8(ldg_na(p), v);
}

// tables in shared memory (the chain's ring)
__device__ __forceinline__ void load8_smem(const float* p, float v[8]) {
  cvt8(reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1], v);
}
__device__ __forceinline__ void load8_smem(const __nv_bfloat16* p, float v[8]) {
  cvt8(*reinterpret_cast<const uint4*>(p), v);
}

// Row state written during the kernel by other CTAs: plain (L1-cached,
// coherent) loads, never the read-only path.  Every wait ends in an acquire
// at GPU scope by one thread and a bar.sync, after which these loads see the
// writers' data.
__device__ __forceinline__ void load8_state(const float* p, float v[8]) {
  cvt8(reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1], v);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum acc[r][b] over the warp's lanes and leave the total of (r, b) in
// res[r] of lane b, for b < nb.  One batch row: a butterfly per
// row.  More: a transposed butterfly that halves the values a lane holds
// at each of the first levels (NR * kBC - 1 shuffles, not 5 per value),
// then one shuffle per row to place the totals.
template <int NR>
__device__ __forceinline__ void warp_totals(float (&acc)[NR][kBC], int nb, float (&res)[NR]) {
  const int lane = threadIdx.x & 31;
  if (nb == 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) res[r] = warp_sum(acc[r][0]);
    return;
  }
  constexpr int NV = NR * kBC;
  float v[NV];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int b = 0; b < kBC; ++b) v[r * kBC + b] = acc[r][b];
  int o = 16, shift = 5;
#pragma unroll
  for (int n = NV; n > 1; n >>= 1, o >>= 1, --shift) {
    const bool upper = lane & o;   // keeps the upper half of its values
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  // lane l now holds the total of value (l >> shift): send (r, b) to lane b
  const int b = lane & (kBC - 1);
#pragma unroll
  for (int r = 0; r < NR; ++r) res[r] = __shfl_sync(0xffffffffu, v[0], (r * kBC + b) << shift);
}

__device__ __forceinline__ float gate(float a, float c) {
  return tanhf(a) * (1.f / (1.f + expf(-c)));
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Synchronisation
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void signal_add(unsigned int* p) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

// Thread 0 waits until *p reaches target (a monotonic counter), then the
// whole CTA proceeds; the acquire makes the writers' data visible.
__device__ __forceinline__ void cta_wait_count(const unsigned int* p, unsigned int target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer();
    for (unsigned int n = 0; static_cast<int>(load_acquire(p) - target) < 0; ++n)
      if ((n & 1023u) == 1023u && globaltimer() - t0 > kWatchdogNs) __trap();
  }
  __syncthreads();
}

// Counter barrier over the `n` CTAs of the vertical group; never reset in a
// launch: barrier k is passed once the counter reaches k * n.
__device__ __forceinline__ void group_sync(unsigned int* count, unsigned int& target, int n) {
  __syncthreads();
  target += n;
  if (threadIdx.x == 0) signal_add(count);
  cta_wait_count(count, target);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = globaltimer();
  for (unsigned int n = 0;; ++n) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023u) == 1023u && globaltimer() - t0 > kWatchdogNs) __trap();
  }
}

// bytes from global to shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// The vertical role: ops over the vertical CTAs' warps (warp `gw` of `nw`
// takes tasks gw, gw + nw, ...; a task is one or two output pairs or gated
// pairs (`unit`) for a chunk of kBC batch rows), weights streamed from
// global memory.
// ---------------------------------------------------------------------------

// res[r] of lane b = sum_{k < klen} w[r][k] * x[b * x_ld + k] for b < nb
// (<= kBC).  Lane l reads the 8-element chunks l, l + 32, ... of each
// weight row, once for all batch rows.
template <typename T, int NR>
__device__ __forceinline__ void warp_dot(const T* const (&w)[NR], const float* x,
                                         long x_ld, int nb, int klen, float (&res)[NR]) {
  const int lane = threadIdx.x & 31;
  float acc[NR][kBC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int b = 0; b < kBC; ++b) acc[r][b] = 0.f;
#pragma unroll 2
  for (int k = lane * 8; k < klen; k += 32 * 8) {
    float wv[NR][8];
#pragma unroll
    for (int r = 0; r < NR; ++r) load8(w[r] + k, wv[r]);
#pragma unroll
    for (int b = 0; b < kBC; ++b) {
      if (b < nb) {
        float xv[8];
        load8_state(x + b * x_ld + k, xv);
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][b] = fmaf(wv[r][i], xv[i], acc[r][b]);
      }
    }
  }
  warp_totals<NR>(acc, nb, res);
}

// y[b, o] = sum_k x[b, k] w[o, k] + add[b, o] for o < nout, 2 * NU
// outputs per task, over groups gy < ngy (the two columns) that offset x
// and y by their strides; `add` also moves by add_row per token row.
// `roll`, when set, first receives the old y[b, o] (same offsets).
struct Lin {
  const void* w; long w_ld;
  int klen;
  const float* x; long x_ld, x_gy;
  const float* add; long add_ld, add_row;
  float* y; long y_ld, y_gy;
  float* roll;
  int nout, nb;
};

template <typename T, int NU>
__device__ void run_lin(const Lin& p, int ngy, int row, int gw, int nw) {
  constexpr int NR = 2 * NU;
  const int lane = threadIdx.x & 31;
  const int nchunk = (p.nb + kBC - 1) / kBC, nunit = p.nout / NR;
  const int ntask = ngy * nunit * nchunk;
  for (int t = gw; t < ntask; t += nw) {
    const int bc = (t % nchunk) * kBC, u = t / nchunk;
    const int o = (u % nunit) * NR, gy = u / nunit;
    const T* w[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) w[r] = static_cast<const T*>(p.w) + (o + r) * p.w_ld;
    const int nb = min(kBC, p.nb - bc);
    const long bb = bc + lane, yi = gy * p.y_gy + o + bb * p.y_ld;
    float extra[NR], old[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {   // lane b < nb owns batch row bc + b: fetch its terms now
      extra[r] = p.add && lane < nb ? __ldg(p.add + row * p.add_row + bb * p.add_ld + o + r) : 0.f;
      old[r] = p.roll && lane < nb ? p.y[yi + r] : 0.f;
    }
    float res[NR];
    warp_dot<T, NR>(w, p.x + gy * p.x_gy + bc * p.x_ld, p.x_ld, nb, p.klen, res);
    if (lane < nb) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (p.roll) p.roll[yi + r] = old[r];
        p.y[yi + r] = res[r] + extra[r];
      }
    }
  }
}

// Gated pairs, NU per task: for j < half, a = dot(x, w[j]) and
// c = dot(x, w[j + half]), pre = (a, c) + bias, stored; then, when `out` is
// set, out[b, j] = tanh(pre_a + cls_a) * sigmoid(pre_c + cls_c).  Groups gy
// (the two columns) offset w, pre and out by their strides.  `roll`, when
// set, receives the old out[b, j] first (the row-state shift).
struct Gated {
  const void* w; long w_ld, w_gy;
  int klen;
  const float* x; long x_ld;
  const float* bias;
  float* pre; long pre_ld, pre_gy;
  const float* cls; long cls_ld;
  float* out; long out_ld, out_gy;
  float* roll;
  int half, nb;
};

template <typename T, int NU>
__device__ void run_gated(const Gated& p, int ngy, int gw, int nw) {
  const int lane = threadIdx.x & 31;
  const int nchunk = (p.nb + kBC - 1) / kBC, nunit = p.half / NU;
  const int ntask = ngy * nunit * nchunk;
  for (int t = gw; t < ntask; t += nw) {
    const int bc = (t % nchunk) * kBC, u = t / nchunk;
    const int j0 = (u % nunit) * NU, gy = u / nunit;
    const T* base = static_cast<const T*>(p.w) + gy * p.w_gy;
    const T* w[2 * NU];   // rows j0 .. j0 + NU - 1, then their c rows
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      w[i] = base + (j0 + i) * p.w_ld;
      w[NU + i] = base + (j0 + i + p.half) * p.w_ld;
    }
    const int nb = min(kBC, p.nb - bc);
    const long bb = bc + lane, oi = gy * p.out_gy + bb * p.out_ld + j0;
    float ea[NU], ec[NU], ca[NU], cc[NU], old[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const bool own = lane < nb, gate_it = own && p.out;
      ea[i] = own ? __ldg(p.bias + j0 + i) : 0.f;
      ec[i] = own ? __ldg(p.bias + j0 + i + p.half) : 0.f;
      ca[i] = gate_it ? __ldg(p.cls + bb * p.cls_ld + j0 + i) : 0.f;
      cc[i] = gate_it ? __ldg(p.cls + bb * p.cls_ld + j0 + i + p.half) : 0.f;
      old[i] = gate_it && p.roll ? p.out[oi + i] : 0.f;
    }
    float res[2 * NU];
    warp_dot<T, 2 * NU>(w, p.x + bc * p.x_ld, p.x_ld, nb, p.klen, res);
    if (lane < nb) {
      float* pr = p.pre + gy * p.pre_gy + bb * p.pre_ld;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const float a = res[i] + ea[i], c = res[NU + i] + ec[i];
        pr[j0 + i] = a;
        pr[j0 + i + p.half] = c;
        if (p.out) {
          if (p.roll) p.roll[oi + i] = old[i];
          p.out[oi + i] = gate(a + ca[i], c + cc[i]);
        }
      }
    }
  }
}

enum : int { kOpLin = 0, kOpGated = 1 };

// One op of the vertical row.  Ops with the same phase run concurrently;
// `last` marks the end of a phase (a group barrier follows), `offset` shifts
// the op's tasks onto warps the phase's earlier ops leave free, `sig`
// (l + 1) marks the op that computes v2h[l]: its phase ends with a signal to
// the chain, and `unit` is the units (output pairs, gated pairs) of a task.
struct alignas(16) Op {
  int kind, gy, last, offset, sig, unit, pad_[2];
  union {
    Lin lin;
    Gated gated;
  };
};
static_assert(sizeof(Op) % sizeof(uint4) == 0, "ops are copied as uint4");

// Ask L2 for the weight rows this warp will read in `op`: weights do not
// depend on the row state, so their DRAM latency overlaps the barrier.
__device__ __forceinline__ void prefetch_l2(const void* p, long bytes) {
  const char* c = static_cast<const char*>(p);
  for (long off = (threadIdx.x & 31) * 128; off < bytes; off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

template <typename T>
__device__ void prefetch_op(const Op& op, int gw, int nw) {
  if (op.kind == kOpLin) {
    const Lin& p = op.lin;
    const int nchunk = (p.nb + kBC - 1) / kBC, nr = 2 * op.unit, nunit = p.nout / nr;
    const int ntask = op.gy * nunit * nchunk;
    for (int t = gw; t < ntask; t += nw) {
      if (t % nchunk) continue;   // one request per task's weight rows
      prefetch_l2(static_cast<const T*>(p.w) + (t / nchunk % nunit) * nr * p.w_ld,
                  nr * p.klen * (long)sizeof(T));
    }
  } else {
    const Gated& p = op.gated;
    const int nchunk = (p.nb + kBC - 1) / kBC, nunit = p.half / op.unit;
    const int ntask = op.gy * nunit * nchunk;
    for (int t = gw; t < ntask; t += nw) {
      if (t % nchunk) continue;
      const int u = t / nchunk, j0 = (u % nunit) * op.unit;
      const T* base = static_cast<const T*>(p.w) + (u / nunit) * p.w_gy;
      prefetch_l2(base + j0 * p.w_ld, op.unit * p.klen * (long)sizeof(T));
      prefetch_l2(base + (j0 + p.half) * p.w_ld, op.unit * p.klen * (long)sizeof(T));
    }
  }
}

int op_tasks(const Op& op) {
  if (op.kind == kOpLin)
    return op.gy * (op.lin.nout / (2 * op.unit)) * ((op.lin.nb + kBC - 1) / kBC);
  return op.gy * (op.gated.half / op.unit) * ((op.gated.nb + kBC - 1) / kBC);
}

// Flags in global memory, one 128-byte line each, all monotonic over the
// launch: the vertical group's barrier, "row sampled" (C arrivals per row)
// and v2h[l] done (one arrival per vertical CTA per row).
struct Flags {
  unsigned int *vbar, *row_done, *v2h_done;   // v2h_done[l * kFlagStride]
};
constexpr int kFlagStride = 32;

// Timeline probe of the vertical group (its first CTA, thread 0), per row:
// the row's start after the "row sampled" wait, the end of every phase, and
// the time spent in that wait.
template <typename T>
__device__ void vertical_role(const Op* __restrict__ ops, int nops, int H, Flags f,
                              long long* trace, char* smem) {
  constexpr int C = kCluster;
  uint4* s4 = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < nops * (int)(sizeof(Op) / sizeof(uint4)); i += kThreads)
    s4[i] = reinterpret_cast<const uint4*>(ops)[i];
  __syncthreads();
  const Op* s_ops = reinterpret_cast<const Op*>(smem);
  const int nv = gridDim.x - C;
  const int nw = nv * kWarps;
  const int gw = (threadIdx.x >> 5) * nv + (blockIdx.x - C);   // spread over SMs
  auto warp_of = [&](const Op& op) { return ((gw - op.offset) % nw + nw) % nw; };
  long long* tr = trace && blockIdx.x == C && threadIdx.x == 0 ? trace : nullptr;
  int tr_stride = 2;
  for (int i = 0; i < nops; ++i) tr_stride += s_ops[i].last;
  unsigned int target = 0;
  for (int row = 0; row < H; ++row) {
    // layer 0 reads the embedding history the chain writes after row - 1
    const unsigned long long t0 = globaltimer();
    if (row > 0) cta_wait_count(f.row_done, static_cast<unsigned int>(row * C));
    if (tr) {
      tr[row * tr_stride] = static_cast<long long>(globaltimer());
      tr[row * tr_stride + tr_stride - 1] = static_cast<long long>(globaltimer() - t0);
    }
    int sig = 0, phase = 0;
    for (int i = 0; i < nops; ++i) {
      const Op& op = s_ops[i];
      if (op.kind == kOpLin) {
        if (op.unit == 2) run_lin<T, 2>(op.lin, op.gy, row, warp_of(op), nw);
        else run_lin<T, 1>(op.lin, op.gy, row, warp_of(op), nw);
      } else {
        if (op.unit == 2) run_gated<T, 2>(op.gated, op.gy, warp_of(op), nw);
        else run_gated<T, 1>(op.gated, op.gy, warp_of(op), nw);
      }
      if (op.sig) sig = op.sig;
      if (op.last) {
        for (int j = i + 1;; ++j) {   // the next phase, wrapping to the next row
          const Op& nx = s_ops[j % nops];
          prefetch_op<T>(nx, warp_of(nx), nw);
          if (nx.last) break;
        }
        if (sig) {                    // this CTA's share of v2h[sig - 1] is written
          __syncthreads();
          if (threadIdx.x == 0) signal_add(f.v2h_done + (sig - 1) * kFlagStride);
          sig = 0;
        }
        group_sync(f.vbar, target, nv);
        if (tr) tr[row * tr_stride + 1 + phase] = static_cast<long long>(globaltimer());
        ++phase;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The chain role: one cluster of C CTAs.
// ---------------------------------------------------------------------------

// Philox-4x32-10 (Salmon et al., SC'11): counter-based, so every (row,
// column, batch row, 4-code group) draws its own stream with no state.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// -log(-log(u)) with u = (24 random bits + 0.5) / 2^24, strictly inside (0, 1)
__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = (static_cast<float>(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// Step kinds of the chain, in the order of `chain_parts` in
// kernels/ar_decode.py: per column, per layer l a gated step (wh) and a
// resid step (wres), fusion_h after layer 0, then the head's hidden (w1) and
// logits (w2) steps.
enum : int { kStepGated = 0, kStepResid = 1, kStepFusion = 2, kStepHidden = 3, kStepLogits = 4 };
enum : int { kFirstPart = 1, kLastPart = 2 };

// One part of a step: units u0 .. u0 + nu of this CTA's slice (a unit is a
// gated pair, rows j and j + d, or one output row), each row klen long, at
// element `off` of the CTA's per-row weight stream.
struct Part {
  int kind, col, layer, klen, u0, nu, off, flags;
};
static_assert(sizeof(Part) == 32, "parts are read as two int4");

struct ChainArgs {
  const Part* parts; int nparts;
  const void* chain; long long row_bytes;    // (C, row_bytes) weight streams
  int nst;                                   // ring stages of kChunk bytes
  const void* emb;
  const float *bhsum, *br, *b1, *b2, *cls, *audh, *v2h, *noise;
  uint2 key;                                 // Philox key when noise is null
  const int* prefix; int prefix_len;         // (B, H, 2)
  int* tokens; float* logits;                // (B, H, 2), (B, H, 2, K) or null
  float* ehist;                              // (B, 2, 3, d) for the vertical group
  long long* trace; long long trace_voff;    // timeline probe, or null
  int cls_smem;                              // cls copied to shared memory
  int B, H, L, d, K, hid, nv;
};

constexpr int kChunk = 16384;   // bytes of a ring stage: one bulk copy

// The chain CTA's shared memory, in bytes (the same carve on host and
// device).  n_own = d / C outputs of a d-wide step, h_own = hid / C,
// k_own = K / C.
struct ChainSmem {
  int x, hist0, xh1, gs, tmp, hid, gum, cval, cidx, wval, widx, tok, parts, bias, cls, v2h1,
      bar, ring, total;
};

// The epilogues' constants of this CTA's outputs, copied to shared memory
// once: bhsum [L][2][n_own] (the a and c halves of its pairs), br
// [L][n_own], b1 [h_own], b2 [k_own]; when `cls_smem`, cls [L][B][2][n_own]
// and column 1's share of v2h [L][B][2][n_own], which column 0's gated
// step l reads beside its own so that column 1's need not go to L2.
__host__ __device__ inline int bias_floats(int L, int n_own, int h_own, int k_own) {
  return 3 * L * n_own + h_own + k_own;
}

__host__ __device__ inline ChainSmem chain_smem(int B, int L, int d, int hid, int K, int nparts,
                                                bool cls_smem, int chunk, int nst) {
  constexpr int C = kCluster;
  ChainSmem s{};
  int o = 0;
  auto take = [&o](int bytes, int align) {
    o = (o + align - 1) / align * align;
    const int at = o;
    o += bytes;
    return at;
  };
  const int n_own = d / C, h_own = hid / C, kx = 2 * d > hid ? 2 * d : hid;
  s.x = take(B * (kx + 4) * 4, 16);             // the step's gathered input
  s.hist0 = take((L + 1) * B * n_own * 4, 16);  // column 0's x_h at every layer
  s.xh1 = take(B * n_own * 4, 16);              // column 1's x_h
  s.gs = take(B * n_own * 4, 16);               // gated output
  s.tmp = take(B * n_own * 4, 16);              // layer-0 output before fusion_h
  s.hid = take(B * h_own * 4, 16);              // head hidden
  s.gum = take(B * (K / C) * 4, 16);            // gumbel noise of this CTA's codes
  s.cval = take(kMaxBatch * 4, 16);             // this CTA's argmax candidates
  s.cidx = take(kMaxBatch * 4, 16);
  s.wval = take(kWarps * 32 * 4, 16);           // per-warp candidates
  s.widx = take(kWarps * 32 * 4, 16);
  s.tok = take(3 * kMaxBatch * 2 * 4, 16);      // tokens of rows r-2, r-1, r
  s.parts = take(nparts * 32, 16);              // the part descriptors
  s.bias = take(bias_floats(L, n_own, h_own, K / C) * 4, 16);
  s.cls = take(cls_smem ? L * B * 2 * n_own * 4 : 0, 16);
  s.v2h1 = take(cls_smem ? L * B * 2 * n_own * 4 : 0, 16);
  s.bar = take(kMaxStages * 8, 8);              // one mbarrier per stage
  s.ring = take(nst * chunk, 128);
  s.total = o;
  return s;
}

// res[r] of lane b = sum_k w[r][k] x[b * x_ld + k] for every batch row
// b < B at once, with weight row r at byte w0[r] of the ring (wrapping at
// ring_bytes) and x in shared memory.  Lane b + s * bp (bp = 1 << bshift,
// the power of two >= B) reads the 8-element chunks s, s + 32 / bp, ... of
// row b: the lanes of one chunk share its weights (a broadcast), the work
// per lane grows with B instead of the tasks, and the sums over a row's
// lanes take log2(32 / bp) shuffles.  x_ld is 4 floats past a multiple of
// 32, so the lanes' x loads fall in different banks.
template <typename T, int NR>
__device__ __forceinline__ void ring_dot(const char* ring, uint32_t ring_bytes,
                                         const uint32_t (&w0)[NR], const float* x, int x_ld,
                                         int B, int bshift, int klen, float (&res)[NR]) {
  const int lane = threadIdx.x & 31;
  const float* xb = x + min(lane & ((1 << bshift) - 1), B - 1) * x_ld;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = (lane >> bshift) * 8; k < klen; k += 256 >> bshift) {
    float xv[8];
    load8_smem(xb + k, xv);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      uint32_t o = w0[r] + k * static_cast<uint32_t>(sizeof(T));
      if (o >= ring_bytes) o -= ring_bytes;
      float wv[8];
      load8_smem(reinterpret_cast<const T*>(ring + o), wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r] = fmaf(wv[i], xv[i], acc[r]);
    }
  }
  for (int o = 16; o >= (1 << bshift); o >>= 1)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
#pragma unroll
  for (int r = 0; r < NR; ++r) res[r] = acc[r];
}

// x[b, k0 + k] = slice k / n_own of CTA k / n_own at (b, k % n_own), for the
// whole cluster's n_own * C outputs: the previous step's result, read over
// distributed shared memory.
__device__ void gather(float* x, int x_ld, int k0, const float* own, int n_own, int B) {
  constexpr int C = kCluster;
  cg::cluster_group cl = cg::this_cluster();
  if ((n_own & 3) == 0) {
    const int n4 = n_own / 4, per_b = C * n4;
    for (int i = threadIdx.x; i < B * per_b; i += kThreads) {
      const int b = i / per_b, r = i - b * per_b, q = r / n4, k4 = r - q * n4;
      const float4* src = reinterpret_cast<const float4*>(cl.map_shared_rank(own, q));
      *reinterpret_cast<float4*>(x + b * x_ld + k0 + q * n_own + k4 * 4) = src[b * n4 + k4];
    }
  } else {
    const int n = n_own * C;
    for (int i = threadIdx.x; i < B * n; i += kThreads) {
      const int b = i / n, k = i - b * n, q = k / n_own;
      x[b * x_ld + k0 + k] = cl.map_shared_rank(own, q)[b * n_own + (k - q * n_own)];
    }
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The rows of a part as a product on the tensor cores (bf16 tables, B > 8):
// a task is 8 rows x 16 batch rows, mma.sync m16n8k16 (bf16 in, f32 sums).
// x is split into bf16 hi + lo, so each product keeps 16 of x's bits
// (2^-17 relative).  k runs in an order that gives lane (g, t) 16
// contiguous bytes of its weight row per 32 k: logical k 2t, 2t+1, 2t+8,
// 2t+9 of half s are elements 8t + 4s + 0..3.  Lane (g, t) ends with batch
// rows m0 + g, m0 + g + 8 of rows n0 + 2t, n0 + 2t + 1, which `terms` and
// `finish` complete (a logits step's candidates go to cand / code, one per
// batch row of the lane).
template <typename Terms, typename Finish>
__device__ __forceinline__ void mma_part(const char* ring, uint32_t ring_bytes, uint32_t pbase,
                                      const float* x, int x_ld, int B, int rows, int klen,
                                      const Terms& terms, const Finish& finish,
                                      float (&cand)[2], int (&code)[2]) {
  using Two = std::integral_constant<int, 2>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = (B + 15) >> 4, g = lane >> 2, t4 = lane & 3;
  for (int t = warp; t < (rows / 8) * mt; t += kWarps) {
    const int m0 = (t % mt) * 16, n0 = (t / mt) * 8;
    uint32_t wrow = pbase + (n0 + g) * klen * 2u;
    if (wrow >= ring_bytes) wrow -= ring_bytes;
    const float* xa = x + min(m0 + g, B - 1) * x_ld + 8 * t4;
    const float* xc = x + min(m0 + g + 8, B - 1) * x_ld + 8 * t4;
    float e[2][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m0 + g + 8 * h < B) terms(m0 + g + 8 * h, n0 + 2 * t4, Two{}, e[h]);
    float dh[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < klen; k0 += 32) {
      uint32_t o = wrow + (k0 + 8 * t4) * 2u;
      if (o >= ring_bytes) o -= ring_bytes;
      const uint4 wq = *reinterpret_cast<const uint4*>(ring + o);
      const float4 xs[4] = {*reinterpret_cast<const float4*>(xa + k0),
                            *reinterpret_cast<const float4*>(xa + k0 + 4),
                            *reinterpret_cast<const float4*>(xc + k0),
                            *reinterpret_cast<const float4*>(xc + k0 + 4)};
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {   // half s: x elements 4s .. 4s + 3
        const float4 ra = xs[hs], rc = xs[2 + hs];
        uint32_t ah[4], al[4];
        split_bf16(ra.x, ra.y, ah[0], al[0]);   // row g, logical k 2t, 2t + 1
        split_bf16(rc.x, rc.y, ah[1], al[1]);   // row g + 8
        split_bf16(ra.z, ra.w, ah[2], al[2]);   // row g, logical k 2t + 8, 2t + 9
        split_bf16(rc.z, rc.w, ah[3], al[3]);
        const uint32_t b0 = hs ? wq.z : wq.x, b1 = hs ? wq.w : wq.y;
        mma_bf16(dh, ah, b0, b1);
        mma_bf16(dl, al, b0, b1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bb = m0 + g + 8 * h;
      if (bb < B) {
        const float v[2] = {dh[2 * h] + dl[2 * h], dh[2 * h + 1] + dl[2 * h + 1]};
        finish(bb, n0 + 2 * t4, Two{}, v, e[h], cand[h], code[h]);
      }
    }
  }
}

template <typename T, bool kTensor>
__device__ void chain_role(const ChainArgs& a, const Flags f, char* smem) {
  cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int C = kCluster;
  const int B = a.B, d = a.d, H = a.H;
  const int n_own = d / C, h_own = a.hid / C, k_own = a.K / C;
  int bshift = 0;   // lanes per batch row in ring_dot: 32 >> bshift
  while ((1 << bshift) < B) ++bshift;
  const ChainSmem lay = chain_smem(B, a.L, d, a.hid, a.K, a.nparts, a.cls_smem, kChunk, a.nst);
  float* x = reinterpret_cast<float*>(smem + lay.x);
  float* hist0 = reinterpret_cast<float*>(smem + lay.hist0);
  float* xh1 = reinterpret_cast<float*>(smem + lay.xh1);
  float* gs = reinterpret_cast<float*>(smem + lay.gs);
  float* tmp = reinterpret_cast<float*>(smem + lay.tmp);
  float* hidb = reinterpret_cast<float*>(smem + lay.hid);
  float* gum = reinterpret_cast<float*>(smem + lay.gum);
  float* cval = reinterpret_cast<float*>(smem + lay.cval);
  int* cidx = reinterpret_cast<int*>(smem + lay.cidx);
  float* wval = reinterpret_cast<float*>(smem + lay.wval);
  int* widx = reinterpret_cast<int*>(smem + lay.widx);
  int* tokh = reinterpret_cast<int*>(smem + lay.tok);      // [slot][b][col]
  Part* parts = reinterpret_cast<Part*>(smem + lay.parts);
  float* bias = reinterpret_cast<float*>(smem + lay.bias);
  float* s_bh = bias;                                        // [L][2][n_own]
  float* s_br = s_bh + 2 * a.L * n_own;                      // [L][n_own]
  float* s_b1 = s_br + a.L * n_own;                          // [h_own]
  float* s_b2 = s_b1 + h_own;                                // [k_own]
  float* s_cls = reinterpret_cast<float*>(smem + lay.cls);   // [L][B][2][n_own]
  float* s_v2h1 = reinterpret_cast<float*>(smem + lay.v2h1); // [L][B][2][n_own]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  char* ring = smem + lay.ring;
  const T* emb = static_cast<const T*>(a.emb);
  const uint32_t ring_bytes = static_cast<uint32_t>(a.nst) * kChunk;
  const char* stream = static_cast<const char*>(a.chain) + q * a.row_bytes;
  const long long total = (a.row_bytes / kChunk) * H;   // chunks of the launch
  // timeline probe (CTA 0, thread 0): per row its start, the end of every
  // step, the row's end, and the time spent waiting for v2h, gathering the
  // steps' inputs (with the gumbel noise) and waiting for weight chunks
  long long* tr = a.trace && q == 0 && tid == 0 ? a.trace : nullptr;
  int tr_stride = 5;
  for (int p = 0; tr && p < a.nparts; ++p)
    tr_stride += (__ldg(&a.parts[p].flags) & kLastPart) ? 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < a.nst; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 3 * kMaxBatch * 2; i += kThreads) tokh[i] = -1;   // no row yet
  for (int i = tid; i < a.nparts * 2; i += kThreads)
    reinterpret_cast<int4*>(parts)[i] = __ldg(reinterpret_cast<const int4*>(a.parts) + i);
  for (int i = tid; i < a.L * n_own; i += kThreads) {
    const int l = i / n_own, j = q * n_own + (i - l * n_own);
    s_bh[(l * 2) * n_own + (i - l * n_own)] = __ldg(a.bhsum + l * 2 * d + j);
    s_bh[(l * 2 + 1) * n_own + (i - l * n_own)] = __ldg(a.bhsum + l * 2 * d + j + d);
    s_br[i] = __ldg(a.br + l * d + j);
  }
  for (int i = tid; i < h_own; i += kThreads) s_b1[i] = __ldg(a.b1 + q * h_own + i);
  for (int i = tid; i < k_own; i += kThreads) s_b2[i] = __ldg(a.b2 + q * k_own + i);
  if (a.cls_smem)
    for (int i = tid; i < a.L * B * 2 * n_own; i += kThreads) {
      const int lb = i / (2 * n_own), h = (i / n_own) & 1, u = i % n_own;
      s_cls[i] = __ldg(a.cls + static_cast<long>(lb) * 2 * d + h * d + q * n_own + u);
    }
  __shared__ int s_v2h_ready;   // the last layer whose v2h this row is known done
  if (tid == 0) s_v2h_ready = -1;
  __syncthreads();
  // the ring: chunk g of the launch (piece g of the row stream, cycling)
  // lands in stage g % nst; thread 0 issues chunk g + nst once chunk g is
  // consumed.  Stages, phases and offsets advance by counting, not dividing.
  long long issued = 0, waited = 0, retired = 0;
  int issue_stage = 0, wait_stage = 0;
  uint32_t wait_phase = 0;
  long long issue_off = 0;
  auto issue_upto = [&](long long end) {
    for (; issued < end && issued < total; ++issued) {
      bulk_load(smem_addr(ring + issue_stage * kChunk), stream + issue_off, kChunk,
                smem_addr(bars + issue_stage));
      if (++issue_stage == a.nst) issue_stage = 0;
      issue_off += kChunk;
      if (issue_off == a.row_bytes) issue_off = 0;
    }
  };
  if (tid == 0) issue_upto(a.nst);
  cluster_sync();   // every CTA of the cluster runs before any remote read

  // Every CTA reduces the cluster's candidates of column `col` to the same
  // tokens (teacher-forced rows take the given token): thread (b, r) reads
  // CTA r's candidate for batch row b, groups of C lanes reduce (C | 32).
  auto sample = [&](int col, int row) {
    const int b = tid / C, r = tid - b * C;
    float v = -INFINITY;
    int i = 0x7fffffff;
    if (b < B && row >= a.prefix_len) {
      v = cl.map_shared_rank(cval, r)[b];
      i = cl.map_shared_rank(cidx, r)[b];
    }
    for (int o = C / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (b < B && r == 0)
      tokh[(2 * kMaxBatch + b) * 2 + col] =
          row < a.prefix_len ? __ldg(a.prefix + (b * H + row) * 2 + col) : i;
    __syncthreads();
  };

  const uint32_t row_step = static_cast<uint32_t>(a.row_bytes % ring_bytes);
  uint32_t row_ring = 0;   // (row * row_bytes) % ring_bytes
  for (int row = 0; row < H; ++row) {
    const long long row_base = row * a.row_bytes;
    if (row) row_ring = (row_ring + row_step) % ring_bytes;
    long long wait_ns = 0, input_ns = 0, ring_ns = 0;
    int step = 0;
    if (tr) tr[row * tr_stride] = static_cast<long long>(globaltimer());
    // a logits step's candidates: lane b's for batch row b (FMA path), and
    // lane (g, t)'s for batch rows m0 + g, m0 + g + 8 (tensor-core path)
    float best = -INFINITY, best2[2];
    int bi = 0x7fffffff, bi2[2];
    for (int p = 0; p < a.nparts; ++p) {
      const int4 p0 = reinterpret_cast<const int4*>(parts + p)[0];
      const int4 p1 = reinterpret_cast<const int4*>(parts + p)[1];
      const int kind = p0.x, col = p0.y, layer = p0.z, klen = p0.w;
      const int u0 = p1.x, nu = p1.y, off = p1.z, flags = p1.w;
      // the input's row stride: its width + 4 floats (see ring_dot)
      const int x_ld = 4 + (kind == kStepLogits ? a.hid : (kind == kStepGated && col == 1 && layer > 0) ? 2 * d : d);
      if (flags & kFirstPart) {   // the step's input
        unsigned long long t_in = tr ? globaltimer() : 0;
        if (kind == kStepGated && col == 0 && tid == 0 && s_v2h_ready < layer) {
          // v2h[layer] of this row; the bar.sync below orders every
          // thread's reads of it after this acquire
          const unsigned long long t0 = globaltimer();
          for (unsigned int n = 0;
               static_cast<int>(load_acquire(f.v2h_done + layer * kFlagStride) -
                                static_cast<unsigned int>((row + 1) * a.nv)) < 0; ++n)
            if ((n & 1023u) == 1023u && globaltimer() - t0 > kWatchdogNs) __trap();
          wait_ns += globaltimer() - t0;
          t_in = globaltimer();
        }

        if (kind == kStepGated) {
          if (col == 0) {
            if (layer > 0) gather(x, x_ld, 0, hist0 + layer * B * n_own, n_own, B);
          } else if (layer == 0) {   // column 1's left tap at layer 0: e0 = emb[t0]
            sample(0, row);
            for (int i = tid; i < B * d; i += kThreads) {
              const int b = i / d;
              x[b * x_ld + (i - b * d)] =
                  to_float(emb[static_cast<long>(tokh[(2 * kMaxBatch + b) * 2]) * d + (i - b * d)]);
            }
          } else {
            gather(x, x_ld, 0, hist0 + layer * B * n_own, n_own, B);
            gather(x, x_ld, d, xh1, n_own, B);
          }
        } else if (kind == kStepResid) {
          gather(x, x_ld, 0, gs, n_own, B);
        } else if (kind == kStepFusion) {
          gather(x, x_ld, 0, tmp, n_own, B);
        } else if (kind == kStepHidden) {
          gather(x, x_ld, 0, col == 0 ? hist0 + a.L * B * n_own : xh1, n_own, B);
        } else {
          gather(x, x_ld, 0, hidb, h_own, B);
          best = best2[0] = best2[1] = -INFINITY;
          bi = bi2[0] = bi2[1] = 0x7fffffff;
          // gumbel noise of this CTA's codes, by all threads at once
          const int rc = row * 2 + col;
          if (a.noise) {
            for (int i = tid; i < B * k_own; i += kThreads) {
              const int b = i / k_own;
              gum[i] = __ldg(a.noise + (static_cast<long>(rc) * B + b) * a.K + q * k_own + (i - b * k_own));
            }
          } else if ((k_own & 3) == 0) {   // one Philox draw per 4 codes
            const int k4 = k_own / 4;
            for (int i = tid; i < B * k4; i += kThreads) {
              const int b = i / k4, o = q * k_own + (i - b * k4) * 4;
              const uint4 r = philox4x32_10(make_uint4(o >> 2, b, rc, 0u), a.key);
              float* g = gum + b * k_own + (o - q * k_own);
              g[0] = gumbel(r.x); g[1] = gumbel(r.y); g[2] = gumbel(r.z); g[3] = gumbel(r.w);
            }
          } else {
            for (int i = tid; i < B * k_own; i += kThreads) {
              const int b = i / k_own, o = q * k_own + (i - b * k_own);
              const uint4 r = philox4x32_10(make_uint4(o >> 2, b, rc, 0u), a.key);
              const int c = o & 3;
              gum[i] = gumbel(c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w);
            }
          }
        }
        __syncthreads();
        if (tr) input_ns += globaltimer() - t_in;
      }
      // wait for every chunk up to the end of this part
      const int urows = kind == kStepGated ? 2 : 1;
      const uint32_t ubytes = urows * klen * static_cast<uint32_t>(sizeof(T));
      const long long s0 = row_base + static_cast<long long>(off) * sizeof(T);
      const long long s1 = s0 + static_cast<long long>(nu) * ubytes;
      const unsigned long long t_ring = tr ? globaltimer() : 0;
      for (const long long need = (s1 + kChunk - 1) / kChunk; waited < need; ++waited) {
        mbar_wait(smem_addr(bars + wait_stage), wait_phase);
        if (++wait_stage == a.nst) { wait_stage = 0; wait_phase ^= 1u; }
      }
      if (tr) ring_ns += globaltimer() - t_ring;
      const uint32_t pbase = (row_ring + static_cast<uint32_t>(off) * sizeof(T)) % ring_bytes;
      if (kind == kStepResid && col == 0 && (flags & kFirstPart) && layer + 1 < a.L &&
          tid == kThreads - 32) {
        // ask one step ahead whether v2h[layer + 1] is done, from the last
        // warp (idle in a resid step): the load's latency overlaps
        // the step, the bar.sync at its end orders it before the next step
        const unsigned int v = load_acquire(f.v2h_done + (layer + 1) * kFlagStride);
        s_v2h_ready = static_cast<int>(v - static_cast<unsigned int>((row + 1) * a.nv)) >= 0
                          ? layer + 1 : layer;
      }

      // The epilogue of rows r0 (and r0 + 1 when nr = 2) of the part for
      // batch row bb: a gated pair (a, c) at unit u0 + r0 / 2, or linear
      // rows at units u0 + r0, ..  `terms` fetches what the rows add (its
      // latency can overlap the dot), `finish` writes the outputs and, in a
      // logits step, keeps the best candidate (value v + noise, code).
      auto terms = [&](int bb, int r0, auto nr_tag, float (&e)[2][2]) {
        constexpr int NR = decltype(nr_tag)::value;
        e[0][0] = e[0][1] = e[1][0] = e[1][1] = 0.f;
        if (kind == kStepGated) {
          const int u = u0 + r0 / 2, j = q * n_own + u;
          const float* v2 = a.v2h + (static_cast<long>(layer) * B + bb) * 4 * d + col * 2 * d;
          float* v2s = s_v2h1 + ((layer * B + bb) * 2) * n_own + u;
          float va, vc;
          if (col == 1 && a.cls_smem) {
            va = v2s[0];
            vc = v2s[n_own];
          } else {
            va = __ldcg(v2 + j);
            vc = __ldcg(v2 + j + d);
            if (col == 0 && a.cls_smem) {   // column 1's share, for its gated step
              v2s[0] = __ldcg(v2 + 2 * d + j);
              v2s[n_own] = __ldcg(v2 + 3 * d + j);
            }
          }
          e[0][0] = s_bh[(layer * 2) * n_own + u] + va;
          e[1][0] = s_bh[(layer * 2 + 1) * n_own + u] + vc;
          if (a.cls_smem) {
            const float* cls = s_cls + ((layer * B + bb) * 2) * n_own + u;
            e[0][1] = cls[0];
            e[1][1] = cls[n_own];
          } else {
            const float* cls = a.cls + (static_cast<long>(layer) * B + bb) * 2 * d;
            e[0][1] = __ldg(cls + j);
            e[1][1] = __ldg(cls + j + d);
          }
          return;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int ur = u0 + r0 + r;
          if (kind == kStepResid) {
            e[r][0] = s_br[layer * n_own + ur];
            if (layer > 0) e[r][0] += (col == 0 ? hist0 + layer * B * n_own : xh1)[bb * n_own + ur];
          } else if (kind == kStepFusion) {
            e[r][0] = __ldg(a.audh + (static_cast<long>(bb) * H + row) * d + q * n_own + ur);
          } else if (kind == kStepHidden) {
            e[r][0] = s_b1[ur];
          } else {
            e[r][0] = s_b2[ur];
            e[r][1] = gum[bb * k_own + ur];
          }
        }
      };
      auto finish = [&](int bb, int r0, auto nr_tag, const float (&v)[2], const float (&e)[2][2],
                        float& cand, int& code) {
        constexpr int NR = decltype(nr_tag)::value;
        if (kind == kStepGated) {
          gs[bb * n_own + u0 + r0 / 2] = gate(v[0] + e[0][0] + e[0][1], v[1] + e[1][0] + e[1][1]);
          return;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int ur = u0 + r0 + r;
          if (kind == kStepResid) {
            float* y = layer == 0 ? tmp : col == 0 ? hist0 + (layer + 1) * B * n_own : xh1;
            y[bb * n_own + ur] = v[r] + e[r][0];
          } else if (kind == kStepFusion) {
            (col == 0 ? hist0 + B * n_own : xh1)[bb * n_own + ur] = v[r] + e[r][0];
          } else if (kind == kStepHidden) {
            hidb[bb * h_own + ur] = fmaxf(v[r] + e[r][0], 0.f);
          } else {
            const int o = q * k_own + ur;
            const float z = v[r] + e[r][0];
            if (a.logits) a.logits[((static_cast<long>(bb) * H + row) * 2 + col) * a.K + o] = z;
            if (better(z + e[r][1], o, cand, code)) { cand = z + e[r][1]; code = o; }
          }
        }
      };
      const int rows = nu * urows;
      using Two = std::integral_constant<int, 2>;
      if (kTensor && rows % 8 == 0 && klen % 32 == 0) {
        if constexpr (kTensor)
          mma_part(ring, ring_bytes, pbase, x, x_ld, B, rows, klen, terms, finish, best2, bi2);
      } else {
        // On the FMA pipes: a task is a gated pair or two rows of a linear
        // step (one where the part's rows are odd), for every batch row;
        // lane bb < B finishes batch row bb
        auto fma_tasks = [&](auto nr_tag) {
          constexpr int NR = decltype(nr_tag)::value;
          const int bb = lane;
          for (int t = warp; t < rows / NR; t += kWarps) {
            const int r0 = t * NR;
            uint32_t w[NR];
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              w[r] = pbase + (r0 + r) * klen * static_cast<uint32_t>(sizeof(T));
              if (w[r] >= ring_bytes) w[r] -= ring_bytes;
            }
            float e[2][2];
            if (bb < B) terms(bb, r0, nr_tag, e);
            float v[NR], v2[2] = {0.f, 0.f};
            ring_dot<T, NR>(ring, ring_bytes, w, x, x_ld, B, bshift, klen, v);
#pragma unroll
            for (int r = 0; r < NR; ++r) v2[r] = v[r];
            if (bb < B) finish(bb, r0, nr_tag, v2, e, best, bi);
          }
        };
        if (kind == kStepGated || rows % 2 == 0)
          fma_tasks(Two{});
        else
          fma_tasks(std::integral_constant<int, 1>{});
      }
      // A step's last part ends at the cluster barrier (which also joins
      // this CTA's threads); the logits step first reduces its candidates.
      // Then the stages the part has consumed are refilled: every read of
      // them came before the barrier.
      const bool last = flags & kLastPart;
      if (!last || kind == kStepLogits) __syncthreads();
      if (last) {
        if (kind == kStepLogits) {   // this CTA's candidate per batch row
          wval[warp * 32 + lane] = best;
          widx[warp * 32 + lane] = bi;
          if constexpr (kTensor) {   // the tensor-core path's: over the 4 lanes of a row
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int o = 1; o < 4; o <<= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, best2[h], o);
                const int oi = __shfl_xor_sync(0xffffffffu, bi2[h], o);
                if (better(ov, oi, best2[h], bi2[h])) { best2[h] = ov; bi2[h] = oi; }
              }
            __syncwarp();
            const int m0 = (warp % ((B + 15) >> 4)) * 16;   // this warp's batch rows
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int bb = m0 + (lane >> 2) + 8 * h;
              if ((lane & 3) == 0 && bb < B &&
                  better(best2[h], bi2[h], wval[warp * 32 + bb], widx[warp * 32 + bb])) {
                wval[warp * 32 + bb] = best2[h];
                widx[warp * 32 + bb] = bi2[h];
              }
            }
          }
          __syncthreads();
          if (tid < B) {
            float bv = -INFINITY;
            int bj = 0x7fffffff;
            for (int w = 0; w < kWarps; ++w)
              if (better(wval[w * 32 + tid], widx[w * 32 + tid], bv, bj)) {
                bv = wval[w * 32 + tid];
                bj = widx[w * 32 + tid];
              }
            cval[tid] = bv;
            cidx[tid] = bj;
          }
        }
        cluster_sync();   // the step's outputs are visible to the cluster
      }
      const long long done = s1 / kChunk;
      if (done > retired) {
        retired = done;
        if (tid == 0) issue_upto(retired + a.nst);
      }
      if (last) {
        if (tr) tr[row * tr_stride + 1 + step] = static_cast<long long>(globaltimer());
        ++step;
      }
    }
    // row end: column 1's tokens, the row's tokens out, this CTA's slice of
    // the embedding history of rows row-2 .. row, then "row sampled"
    sample(1, row);
    if (q == 0 && tid < 2 * B) a.tokens[((tid >> 1) * H + row) * 2 + (tid & 1)] = tokh[2 * kMaxBatch * 2 + tid];
    for (int i = tid; i < B * 6 * n_own; i += kThreads) {
      const int k = i % n_own, r = (i / n_own) % 3, c = (i / n_own / 3) % 2, b = i / n_own / 6;
      const int tok = tokh[(r * kMaxBatch + b) * 2 + c];
      const int o = q * n_own + k;
      a.ehist[((b * 2 + c) * 3 + r) * d + o] = tok < 0 ? 0.f : to_float(emb[static_cast<long>(tok) * d + o]);
    }
    __syncthreads();
    if (tid == 0) {
      signal_add(f.row_done);
      s_v2h_ready = -1;
    }
    if (tr) {
      tr[row * tr_stride + step + 1] = static_cast<long long>(globaltimer());
      tr[row * tr_stride + step + 2] = wait_ns;
      tr[row * tr_stride + step + 3] = input_ns;
      tr[row * tr_stride + step + 4] = ring_ns;
    }
    if (tid < 2 * B) {
      tokh[tid] = tokh[kMaxBatch * 2 + tid];
      tokh[kMaxBatch * 2 + tid] = tokh[2 * kMaxBatch * 2 + tid];
    }
    __syncthreads();
  }
  cluster_sync();   // no CTA leaves while another may still read its memory
}

struct Args {
  ChainArgs chain;
  const Op* ops;
  int nops;
  Flags flags;
};

// CTAs 0 .. kCluster-1 form the first cluster: the chain.  The rest, in
// clusters of the same size that never use them, are the vertical group.
// kTensor: the chain's parts go to the tensor cores (bf16 tables, B > 8);
// without it that code is left out, and so are its registers.
template <typename T, bool kTensor>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  if (blockIdx.x < kCluster)
    chain_role<T, kTensor>(a.chain, a.flags, smem);
  else
    vertical_role<T>(a.ops, a.nops, a.chain.H, a.flags,
                     a.chain.trace ? a.chain.trace + a.chain.trace_voff : nullptr, smem);
}

struct Dims {
  int B, H, L, d, K, hid;
};

// vertical ops per token row: L layers + fusion_v + L v2h
int vertical_ops(int L) { return 2 * L + 1; }

// Scratch layout (f32), carved in this order:
//   ehist (B,2,3,d)    embedding rows i-3..i-1 per column (written by the chain)
//   xs    (L-1,B,2,2d) inputs of vertical layers 1.. [col][prev|cur]
//   xv0   (B,2,d)      layer-0 gated output before fusion_v
//   hv    (L,B,2,2d)   pre-gate vertical features
//   v2h   (L,B,2,2d)
//   flags (L+2) lines  vertical barrier, row sampled, v2h[l] done
//   ops   the vertical op list of one row
struct Scratch {
  float *ehist, *xs, *xv0, *hv, *v2h;
  Flags flags;
  Op* ops;
};

constexpr int kScratchParts = 7;
void scratch_sizes(const Dims& m, long (&n)[kScratchParts]) {
  const long B = m.B, L = m.L, d = m.d;
  const long op_floats = (vertical_ops(m.L) * (long)sizeof(Op) + 63) / 64 * 16;
  const long sizes[kScratchParts] = {B * 6 * d, (L - 1) * B * 4 * d, B * 2 * d, L * B * 4 * d,
                                     L * B * 4 * d, (L + 2) * kFlagStride, op_floats};
  for (int i = 0; i < kScratchParts; ++i) n[i] = (sizes[i] + 15) / 16 * 16;  // 64-byte aligned parts
}

long scratch_total(const Dims& m) {
  long n[kScratchParts], total = 0;
  scratch_sizes(m, n);
  for (long v : n) total += v;
  return total;
}

Scratch carve(float* base, const Dims& m) {
  long n[kScratchParts];
  scratch_sizes(m, n);
  float* parts[kScratchParts];
  for (int i = 0; i < kScratchParts; ++i) { parts[i] = base; base += n[i]; }
  unsigned int* fl = reinterpret_cast<unsigned int*>(parts[5]);
  return Scratch{parts[0], parts[1], parts[2], parts[3], parts[4],
                 Flags{fl, fl + kFlagStride, fl + 2 * kFlagStride}, reinterpret_cast<Op*>(parts[6])};
}

struct Tables {
  const void *wv0, *wvB, *wv2h, *wfv;
  const float* bv;
};

Op lin_op(const Lin& p, int sig = 0) {
  Op op{};
  op.kind = kOpLin; op.gy = 2; op.sig = sig; op.unit = 1; op.lin = p;
  return op;
}

Op gated_op(const Gated& p) {
  Op op{};
  op.kind = kOpGated; op.gy = 2; op.unit = 1; op.gated = p;
  return op;
}

#define TRY(expr)                           \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// Ops of one row with their dependencies; `schedule` puts each op in the
// phase after its latest dependency, so v2h[l] overlaps layer l + 1.  Every
// buffer has one writer per row and is read only by ops that depend on that
// writer, so ops sharing a phase never touch each other's outputs.
struct RowBuilder {
  std::vector<Op> ops;
  std::vector<int> phase;
  int add(const Op& op, std::initializer_list<int> deps) {
    int p = 0;
    for (int dep : deps) p = std::max(p, phase[dep] + 1);
    ops.push_back(op);
    phase.push_back(p);
    return static_cast<int>(ops.size()) - 1;
  }
  std::vector<Op> schedule(int nw) const {
    std::vector<Op> out;
    const int nphase = *std::max_element(phase.begin(), phase.end()) + 1;
    for (int ph = 0; ph < nphase; ++ph) {
      int offset = 0;
      for (size_t i = 0; i < ops.size(); ++i) {
        if (phase[i] != ph) continue;
        Op op = ops[i];
        // two units per task where that still leaves a task for every
        // warp (large B): each weight row and input chunk a task reads
        // serves twice the products, which is what the phase waits on there
        op.unit = 2;
        if (op_tasks(op) < nw) op.unit = 1;
        op.offset = offset % nw;
        op.last = 0;
        offset += op_tasks(op);
        out.push_back(op);
      }
      out.back().last = 1;
    }
    return out;
  }
};

// The vertical group's ops of one token row (both columns as groups gy).
template <typename T>
std::vector<Op> row_ops(const Dims& m, const Tables& t, const Scratch& s, const float* cls,
                        const float* audv, int nw) {
  const long B = m.B, d = m.d, H = m.H;
  const long d2 = 2 * d, d4 = 4 * d;
  RowBuilder rb;
  auto v2h_op = [&](int l) {
    Lin v{};
    v.w = static_cast<const T*>(t.wv2h) + l * d2 * d2; v.w_ld = d2; v.klen = d2;
    v.x = s.hv + l * B * d4; v.x_ld = d4; v.x_gy = d2;
    v.y = s.v2h + l * B * d4; v.y_ld = d4; v.y_gy = d2;
    v.nout = d2; v.nb = m.B;
    return lin_op(v, l + 1);
  };
  int vert;
  {  // layer 0: mask A over the 3 history rows -> hv[0], gate -> xv0
    Gated g{};
    g.w = t.wv0; g.w_ld = 6 * d; g.w_gy = d2 * 6 * d; g.klen = 6 * d;
    g.x = s.ehist; g.x_ld = 6 * d;
    g.bias = t.bv;
    g.pre = s.hv; g.pre_ld = d4; g.pre_gy = d2;
    g.cls = cls; g.cls_ld = d2;
    g.out = s.xv0; g.out_ld = d2; g.out_gy = d;
    g.half = d; g.nb = m.B;
    vert = rb.add(gated_op(g), {});
  }
  {  // fusion_v: x-part matmul + per-row audio term -> layer-1 current row
    Lin f{};
    f.w = t.wfv; f.w_ld = d; f.klen = d;
    f.x = s.xv0; f.x_ld = d2; f.x_gy = d;
    f.add = audv; f.add_ld = H * d; f.add_row = d;
    f.y = s.xs + d; f.y_ld = d4; f.y_gy = d2;
    f.roll = s.xs;
    f.nout = d; f.nb = m.B;
    const int fv = rb.add(lin_op(f), {vert});
    rb.add(v2h_op(0), {vert});
    vert = fv;
  }
  for (int l = 1; l < m.L; ++l) {
    Gated g{};
    g.w = static_cast<const T*>(t.wvB) + (l - 1) * 2 * d2 * d4;
    g.w_ld = d4; g.w_gy = d2 * d4; g.klen = d4;
    g.x = s.xs + (l - 1) * B * d4; g.x_ld = d4;
    g.bias = t.bv + l * d2;
    g.pre = s.hv + l * B * d4; g.pre_ld = d4; g.pre_gy = d2;
    if (l < m.L - 1) {
      g.cls = cls + l * B * d2; g.cls_ld = d2;
      g.out = s.xs + l * B * d4 + d; g.out_ld = d4; g.out_gy = d2;
      g.roll = s.xs + l * B * d4;
    }
    g.half = d; g.nb = m.B;
    vert = rb.add(gated_op(g), {vert});
    rb.add(v2h_op(l), {vert});
  }
  return rb.schedule(nw);
}

struct Launch {
  int cluster, nv, smem, nst;
};

template <typename T>
cudaError_t decode(const Dims& m, const Tables& t, ChainArgs ca, const float* cls,
                   const float* audv, float* scratch, int part_bytes, Launch* info,
                   cudaStream_t st) {
  int dev = 0, sms = 0, cap = 0;
  TRY(cudaGetDevice(&dev));
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  TRY(cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  constexpr int C = kCluster;
  if (m.d % C || m.hid % C || m.K % C || m.B > kMaxBatch || part_bytes % 32)
    return cudaErrorInvalidValue;
  // the ring takes what shared memory the chain's buffers leave (cls goes
  // there too while the ring keeps 12 stages); a part of at most
  // part_bytes must fit beside a chunk it may start in
  auto stages = [&](bool cls_smem) {
    const int fixed = chain_smem(m.B, m.L, m.d, m.hid, m.K, ca.nparts, cls_smem, kChunk, 0).total;
    return std::min(kMaxStages, (std::min(cap, kSmemCap) - (fixed + 127) / 128 * 128) / kChunk);
  };
  ca.cls_smem = stages(true) >= 12;
  ca.nst = stages(ca.cls_smem);
  if (ca.nst * kChunk < part_bytes + 2 * kChunk) return cudaErrorInvalidValue;
  const int smem = std::max(
      chain_smem(m.B, m.L, m.d, m.hid, m.K, ca.nparts, ca.cls_smem, kChunk, ca.nst).total,
      vertical_ops(m.L) * static_cast<int>(sizeof(Op)));
  void (*kernel)(Args) = decode_kernel<T, false>;
  if constexpr (sizeof(T) == 2)
    if (m.B > 8) kernel = decode_kernel<T, true>;
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));

  // every CTA must be resident at once (the roles wait on each other): size
  // the grid from the clusters the card can hold, one chain + >= 1 vertical,
  // and launch it cooperative, which CUDA refuses unless all of it can be
  // resident
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(sms / C * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  TRY(cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg));
  clusters = std::min(clusters, sms / C);
  if (clusters < 2) return cudaErrorCooperativeLaunchTooLarge;
  cfg.gridDim = dim3(clusters * C);
  cfg.numAttrs = 2;
  ca.nv = (clusters - 1) * C;
  if (info) *info = Launch{C, ca.nv, smem, ca.nst};

  const Scratch s = carve(scratch, m);
  const std::vector<Op> ops = row_ops<T>(m, t, s, cls, audv, ca.nv * kWarps);
  if (static_cast<int>(ops.size()) != vertical_ops(m.L)) return cudaErrorInvalidValue;
  ca.v2h = s.v2h;
  ca.ehist = s.ehist;
  TRY(cudaMemsetAsync(scratch, 0, scratch_total(m) * sizeof(float), st));
  // pageable source: the copy is staged before this call returns
  TRY(cudaMemcpyAsync(s.ops, ops.data(), ops.size() * sizeof(Op), cudaMemcpyHostToDevice, st));
  const Args args{ca, s.ops, static_cast<int>(ops.size()), s.flags};
  TRY(cudaLaunchKernelEx(&cfg, kernel, args));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* talkshow_ar_decode_error(int e) {
  return cudaGetErrorName(static_cast<cudaError_t>(e));
}

// Floats of scratch that talkshow_ar_decode needs for these dimensions.
long long talkshow_ar_decode_scratch(int B, int L, int dim) {
  return scratch_total(Dims{B, 1, L, dim, 0, 0});
}

// Decode the (H, 2) token grid of B samples on `stream`.  table_dtype: 0 f32
// tables, 1 bf16 tables.  The chain's weights are `chain` (16,
// row_bytes), one stream per CTA of the chain's cluster, with `nparts` part descriptors (8 int32 each) from
// kernels/ar_decode.py:chain_parts, streamed in chunks of chunk_bytes; no
// part is longer than part_bytes.  noise (H, 2, B, K) f32 or null for
// Philox keyed by `seed`.  prefix (B, H, 2) int32 or null.  logits
// (B, H, 2, K) or null.  trace (int64, may be null): the timeline probe,
// the chain's rows from 0 and the vertical group's from trace_voff.
// info (4 ints, may be null) receives the launch's
// shape: cluster size, vertical CTAs, shared memory per CTA, ring stages.
// Returns the first CUDA error (0 on success); nothing here synchronises.
int talkshow_ar_decode(int table_dtype, int B, int H, int L, int dim, int K, int hidden,
                       int chunk_bytes, int part_bytes, const int* parts,
                       int nparts, long long row_bytes, const void* wv0, const void* wvB,
                       const void* wv2h, const void* wfv, const void* emb, const void* chain,
                       const float* bv, const float* bhsum, const float* br, const float* b1,
                       const float* b2, const float* cls, const float* audv,
                       const float* audh, const float* noise, unsigned long long seed,
                       const int* prefix, int prefix_len, int* tokens, float* logits,
                       float* scratch, long long* trace, long long trace_voff, int* info,
                       void* stream) {
  const Dims m{B, H, L, dim, K, hidden};
  const Tables t{wv0, wvB, wv2h, wfv, bv};
  ChainArgs ca{};
  ca.parts = reinterpret_cast<const Part*>(parts); ca.nparts = nparts;
  ca.chain = chain; ca.row_bytes = row_bytes;
  ca.emb = emb;
  ca.bhsum = bhsum; ca.br = br; ca.b1 = b1; ca.b2 = b2; ca.cls = cls; ca.audh = audh;
  ca.noise = noise;
  ca.key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  ca.prefix = prefix; ca.prefix_len = prefix ? prefix_len : 0;
  ca.tokens = tokens; ca.logits = logits;
  ca.trace = trace; ca.trace_voff = trace_voff;
  ca.B = B; ca.H = H; ca.L = L; ca.d = dim; ca.K = K; ca.hid = hidden;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Launch* li = reinterpret_cast<Launch*>(info);
  cudaError_t e;
  if (chunk_bytes != kChunk || row_bytes % kChunk)
    e = cudaErrorInvalidValue;
  else if (table_dtype == 0)
    e = decode<float>(m, t, ca, cls, audv, scratch, part_bytes, li, st);
  else if (table_dtype == 1)
    e = decode<__nv_bfloat16>(m, t, ca, cls, audv, scratch, part_bytes, li, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"

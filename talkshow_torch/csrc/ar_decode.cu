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
// What bounds it on the card: every row reads all the prior's weights once,
// ~47 MB in bf16 at dim 256 / 15 layers / K 2048 (~94 MB in f32), for GEMVs
// with M = B <= 32, through a chain of ~70 dependent steps.  At these sizes
// the decode is bound by latency (one L2/HBM round trip plus one grid-wide
// synchronisation per step, ~3-4 us) far more than by the ~14 us per row
// that 47 MB costs at 3.35 TB/s.
//
// What the design does about it, for now:
// - ONE cooperative persistent kernel per decode (one block per SM):
//   the host lists the 99 ops of one row (gated GEMV, linear GEMV, sample)
//   once per call, grouped into ~70 phases by their dependencies, so the
//   vertical stack, the per-layer v2h and column 0's horizontal pass overlap;
//   the kernel walks rows x phases with a grid barrier (~1 us) between
//   phases instead of a kernel launch per step.  The op list lives in shared
//   memory, and before each barrier every warp asks L2 for the weight rows it
//   will read in the next phase (weights do not depend on the row state).
// - Weights are packed output-major for Hopper (no zero quadrants or
//   block-diagonal copies, which the TPU layout needed only because Mosaic
//   cannot concatenate across lane tiles).  A task is one output (or one
//   gated pair j, j+dim) for a chunk of 4 batch rows; its warp streams the
//   weight row with 16-byte loads.  Epilogues fuse bias, class embedding,
//   gating, residual, ReLU and the state roll.
// - Column 0's horizontal pass is computed once (it does not depend on the
//   column-0 token) instead of twice.
// - Row state written by one block and read by another is read with
//   coherent loads after an acquire at each barrier, never through the
//   read-only (non-coherent) path.
// Tables are bf16 (f32 for exact comparison), accumulation and all row state
// f32 — activations stay f32 rather than being rounded to the table type.
// wgmma/TMA for larger batches and thread-block clusters for the horizontal
// chain are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <vector>

namespace {

constexpr int kWarps = 16;              // warps per block (one block per SM)
constexpr int kThreads = kWarps * 32;
constexpr int kBC = 4;                  // batch rows per accumulator pass

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // bf16 -> f32: the high 16 bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Row state, written during the kernel by other blocks: plain (L1-cached,
// coherent) loads, never the read-only path.  Each grid barrier ends in an
// acquire at GPU scope, after which these loads see every block's writes.
__device__ __forceinline__ void load8_state(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r][b] = sum_{k < klen} w[r][k] * x[b * x_ld + k] for b < nb (<= kBC),
// summed over the warp; every lane ends with the totals.  Lane l reads the
// 8-element chunks l, l + 32, ... so each weight row streams in 16-byte
// (bf16) or 32-byte (f32) pieces per lane and is read once for all batch rows.
template <typename T, int NR>
__device__ __forceinline__ void warp_dot(const T* const (&w)[NR], const float* x,
                                         long x_ld, int nb, int klen,
                                         float (&acc)[NR][kBC]) {
  const int lane = threadIdx.x & 31;
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
#pragma unroll
  for (int b = 0; b < kBC; ++b)
    if (b < nb)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r][b] = warp_sum(acc[r][b]);
}


// ---------------------------------------------------------------------------
// Ops.  Each is executed by the whole grid: warp `gw` of `nw` takes tasks
// gw, gw + nw, ...; a task is one output (linear) or one gated pair, for one
// chunk of kBC batch rows.
// ---------------------------------------------------------------------------

// y[b, o] = relu?(sum_k x[b, k] w[o, k0 + k] + bias[o] + add[b, o]) for
// o < nout, over groups gy < ngy (the two columns) that offset x and y by
// their strides; `add` and `y` also move by add_row / y_row per token row.
// `roll`, when set, first receives the old y[b, o] (same offsets).
struct Lin {
  const void* w; long w_ld;
  int k0, klen;
  const float* x; long x_ld, x_gy;
  const float* bias;
  const float* add; long add_ld, add_row;
  float* y; long y_ld, y_gy, y_row;
  float* roll;
  int nout, nb, relu;
};

template <typename T>
__device__ void run_lin(const Lin& p, int ngy, int row, int gw, int nw) {
  const int lane = threadIdx.x & 31;
  const int nchunk = (p.nb + kBC - 1) / kBC;
  const int ntask = ngy * p.nout * nchunk;
  for (int t = gw; t < ntask; t += nw) {
    const int bc = (t % nchunk) * kBC, u = t / nchunk;
    const int o = u % p.nout, gy = u / p.nout;
    const T* const w[1] = {static_cast<const T*>(p.w) + o * p.w_ld + p.k0};
    const float* x = p.x + gy * p.x_gy;
    const long y_off = row * p.y_row + gy * p.y_gy + o;
    {
      const int nb = min(kBC, p.nb - bc);
      // lane b < nb owns batch row bc + b: fetch its epilogue terms now, so
      // their latency overlaps the dot product
      const long bb = bc + lane, yi = y_off + bb * p.y_ld;
      float extra = 0.f, old = 0.f;
      if (lane < nb) {
        if (p.bias) extra = p.bias[o];
        if (p.add) extra += p.add[row * p.add_row + bb * p.add_ld + o];
        if (p.roll) old = p.y[yi];
      }
      float acc[1][kBC];
      warp_dot<T, 1>(w, x + bc * p.x_ld, p.x_ld, nb, p.klen, acc);
#pragma unroll
      for (int b = 0; b < kBC; ++b) {
        if (b < nb && lane == b) {
          float v = acc[0][b] + extra;
          if (p.relu) v = fmaxf(v, 0.f);
          if (p.roll) p.roll[yi] = old;
          p.y[yi] = v;
        }
      }
    }
  }
}

// Gated pair: for j < half, a = dot(x, w[j]) and c = dot(x, w[j + half]),
// pre = (a, c) + bias + add; pre is stored when `pre` is set; then
// out[b, j] = tanh(pre_a + cls_a) * sigmoid(pre_c + cls_c).  Groups gy
// (the two columns) offset w, pre and out by their strides.  `roll`,
// when set, receives the old out[b, j] first (the row-state shift).
struct Gated {
  const void* w; long w_ld, w_gy;
  int k0, klen;
  const float* x; long x_ld;
  const float* bias;
  const float* add; long add_ld;
  float* pre; long pre_ld, pre_gy;
  const float* cls; long cls_ld;
  float* out; long out_ld, out_gy;
  float* roll;
  int half, nb;
};

template <typename T>
__device__ void run_gated(const Gated& p, int ngy, int gw, int nw) {
  const int lane = threadIdx.x & 31;
  const int nchunk = (p.nb + kBC - 1) / kBC;
  const int ntask = ngy * p.half * nchunk;
  for (int t = gw; t < ntask; t += nw) {
    const int bc = (t % nchunk) * kBC, u = t / nchunk;
    const int j = u % p.half, gy = u / p.half;
    const T* base = static_cast<const T*>(p.w) + gy * p.w_gy + p.k0;
    const T* const w[2] = {base + j * p.w_ld, base + (j + p.half) * p.w_ld};
    const float* x = p.x;
    {
      const int nb = min(kBC, p.nb - bc);
      // lane b < nb owns batch row bc + b: fetch its epilogue terms now
      const long bb = bc + lane, oi = gy * p.out_gy + bb * p.out_ld + j;
      float ea = 0.f, ec = 0.f, ca = 0.f, cc = 0.f, old = 0.f;
      if (lane < nb) {
        if (p.bias) { ea = p.bias[j]; ec = p.bias[j + p.half]; }
        if (p.add) {
          const float* ad = p.add + bb * p.add_ld;
          ea += ad[j];
          ec += ad[j + p.half];
        }
        if (p.cls) { ca = p.cls[bb * p.cls_ld + j]; cc = p.cls[bb * p.cls_ld + j + p.half]; }
        if (p.out && p.roll) old = p.out[oi];
      }
      float acc[2][kBC];
      warp_dot<T, 2>(w, x + bc * p.x_ld, p.x_ld, nb, p.klen, acc);
#pragma unroll
      for (int b = 0; b < kBC; ++b) {
        if (b < nb && lane == b) {
          const float a = acc[0][b] + ea, c = acc[1][b] + ec;
          if (p.pre) {
            float* pr = p.pre + gy * p.pre_gy + bb * p.pre_ld;
            pr[j] = a;
            pr[j + p.half] = c;
          }
          if (p.out) {
            if (p.roll) p.roll[oi] = old;
            p.out[oi] = tanhf(a + ca) * (1.f / (1.f + expf(-(c + cc))));
          }
        }
      }
    }
  }
}

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

struct Sample {
  const float* logits; long logits_ld, logits_row;  // batch row b at + b * logits_ld
  const float* noise;                    // (H, 2, B, K) or null
  uint2 key;                             // Philox key when noise is null
  const int* prefix; int prefix_len;     // (B, H, 2)
  int* tokens;                           // (B, H, 2)
  const void* emb;                       // (K, dim) table
  float* seed_out; long seed_ld;         // col 0: e0 -> x_h col-0 input of layer 0
  float* ehist;                          // col 1: (B, 2, 3, dim) history roll
  int B, K, H, dim, col;
};

// Block b < B samples batch row b: z = logits + gumbel, first-index argmax
// over the real K (teacher-forced rows take the given token), emit the token,
// and feed its embedding back.  Other blocks have nothing to do.
template <typename T>
__device__ void run_sample(const Sample& p, int row) {
  const int b = blockIdx.x;
  if (b >= p.B) return;
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_tok;
  if (row < p.prefix_len) {
    if (threadIdx.x == 0) s_tok = __ldg(p.prefix + (b * p.H + row) * 2 + p.col);
  } else {
    const float* lg = p.logits + row * p.logits_row + b * p.logits_ld;
    const float* nz = p.noise ? p.noise + ((long)(row * 2 + p.col) * p.B + b) * p.K : nullptr;
    float best = -INFINITY;
    int bi = 0x7fffffff;
    for (int k4 = threadIdx.x * 4; k4 < p.K; k4 += kThreads * 4) {
      float g[4];
      if (nz) {
        const float4 n = __ldg(reinterpret_cast<const float4*>(nz + k4));
        g[0] = n.x; g[1] = n.y; g[2] = n.z; g[3] = n.w;
      } else {
        const uint4 r = philox4x32_10(make_uint4(k4 >> 2, b, row * 2 + p.col, 0u), p.key);
        g[0] = gumbel(r.x); g[1] = gumbel(r.y); g[2] = gumbel(r.z); g[3] = gumbel(r.w);
      }
      const float4 l4 = *reinterpret_cast<const float4*>(lg + k4);
      const float z[4] = {l4.x + g[0], l4.y + g[1], l4.z + g[2], l4.w + g[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (z[i] > best) { best = z[i]; bi = k4 + i; }   // ascending k: keeps the first max
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if ((threadIdx.x & 31) == 0) { s_val[threadIdx.x >> 5] = best; s_idx[threadIdx.x >> 5] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (s_val[w] > best || (s_val[w] == best && s_idx[w] < bi)) { best = s_val[w]; bi = s_idx[w]; }
      s_tok = bi;
    }
  }
  __syncthreads();
  const int tok = s_tok;
  if (threadIdx.x == 0) p.tokens[(b * p.H + row) * 2 + p.col] = tok;
  const T* emb = static_cast<const T*>(p.emb);
  if (p.col == 0) {
    for (int i = threadIdx.x; i < p.dim; i += kThreads)
      p.seed_out[b * p.seed_ld + i] = to_float(emb[(long)tok * p.dim + i]);
  } else {
    const int tok0 = p.tokens[(b * p.H + row) * 2];
    for (int i = threadIdx.x; i < p.dim; i += kThreads) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float* h = p.ehist + ((long)(b * 2 + c) * 3) * p.dim + i;
        h[0] = h[p.dim];
        h[p.dim] = h[2 * p.dim];
        h[2 * p.dim] = to_float(emb[(long)(c == 0 ? tok0 : tok) * p.dim + i]);
      }
    }
  }
}

enum : int { kOpLin = 0, kOpGated = 1, kOpSample = 2 };

// One op of a row.  Ops with the same phase run concurrently; `last` marks
// the end of a phase (a grid barrier follows), and `offset` shifts the op's
// tasks onto warps the phase's earlier ops leave free.
struct alignas(16) Op {
  int kind, gy, last, offset;
  union {
    Lin lin;
    Gated gated;
    Sample sample;
  };
};

// Grid-wide barrier for a cooperative launch (every block co-resident).
// One counter, never reset during a launch: barrier n is passed once it
// reaches n * gridDim.x.  The release on arrival publishes this block's
// writes; the acquire load while waiting makes every block's writes visible
// to this block's loads after the barrier.
__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void grid_sync(unsigned int* count, unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    unsigned int old;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(count) : "memory");
    while (static_cast<int>(load_acquire(count) - target) < 0) {
    }
  }
  __syncthreads();
}

// Ask L2 for the weight rows this warp will read in `op`: weights do not
// depend on the row state, so their DRAM latency can overlap the current op
// and the barrier.
__device__ __forceinline__ void prefetch_l2(const void* p, long bytes) {
  const char* c = static_cast<const char*>(p);
  for (long off = (threadIdx.x & 31) * 128; off < bytes; off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

template <typename T>
__device__ void prefetch_op(const Op& op, int gw, int nw) {
  if (op.kind == kOpLin) {
    const Lin& p = op.lin;
    const int nchunk = (p.nb + kBC - 1) / kBC;
    const int ntask = op.gy * p.nout * nchunk;
    for (int t = gw; t < ntask; t += nw) {
      if (t % nchunk) continue;   // one request per weight row
      prefetch_l2(static_cast<const T*>(p.w) + (t / nchunk % p.nout) * p.w_ld + p.k0,
                  p.klen * (long)sizeof(T));
    }
  } else if (op.kind == kOpGated) {
    const Gated& p = op.gated;
    const int nchunk = (p.nb + kBC - 1) / kBC;
    const int ntask = op.gy * p.half * nchunk;
    for (int t = gw; t < ntask; t += nw) {
      if (t % nchunk) continue;
      const int u = t / nchunk;
      const T* base = static_cast<const T*>(p.w) + (u / p.half) * p.w_gy + p.k0;
      prefetch_l2(base + (u % p.half) * p.w_ld, p.klen * (long)sizeof(T));
      prefetch_l2(base + (u % p.half + p.half) * p.w_ld, p.klen * (long)sizeof(T));
    }
  }
}

int op_tasks(const Op& op) {
  if (op.kind == kOpLin)
    return op.gy * op.lin.nout * ((op.lin.nb + kBC - 1) / kBC);
  if (op.kind == kOpGated) return op.gy * op.gated.half * ((op.gated.nb + kBC - 1) / kBC);
  return op.sample.B;
}

// The decode: for each token row, run the row's phases in order, a grid
// barrier after each.  The op list is copied to shared memory once, so a
// phase starts without a trip to memory for its descriptors.  Before each
// barrier a warp asks L2 for the weights of its tasks in the next phase.
// No block returns early: all reach every barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Op* __restrict__ ops,
                                                          int nops, int H,
                                                          unsigned int* bar) {
  extern __shared__ uint4 smem[];
  Op* s_ops = reinterpret_cast<Op*>(smem);
  for (int i = threadIdx.x; i < nops * (int)(sizeof(Op) / sizeof(uint4)); i += kThreads)
    smem[i] = reinterpret_cast<const uint4*>(ops)[i];
  __syncthreads();
  const int nw = gridDim.x * kWarps;
  const int gw = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;  // spread over SMs
  auto warp_of = [&](const Op& op) { return ((gw - op.offset) % nw + nw) % nw; };
  unsigned int target = 0;
  for (int row = 0; row < H; ++row) {
    for (int i = 0; i < nops; ++i) {
      const Op& op = s_ops[i];
      if (op.kind == kOpLin)
        run_lin<T>(op.lin, op.gy, row, warp_of(op), nw);
      else if (op.kind == kOpGated)
        run_gated<T>(op.gated, op.gy, warp_of(op), nw);
      else
        run_sample<T>(op.sample, row);
      if (op.last) {
        for (int j = i + 1;; ++j) {   // the next phase, wrapping to the next row
          const Op& nx = s_ops[j % nops];
          prefetch_op<T>(nx, warp_of(nx), nw);
          if (nx.last) break;
        }
        grid_sync(bar, target);
      }
    }
  }
}

struct Dims {
  int B, H, L, d, K, hid;
};

// ops per token row: L vertical layers + fusion_v + L v2h, then per column
// L x (gated + resid) + fusion_h + 2 head linears + sample
int ops_per_row(int L) { return (2 * L + 1) + 2 * (2 * L + 4); }

static_assert(sizeof(Op) % sizeof(uint4) == 0, "ops are copied as uint4");

// Scratch layout (f32), carved in this order:
//   ehist (B,2,3,d)  embedding rows i-3..i-1 per column
//   xs    (L-1,B,2,2,d)  inputs of vertical layers 1.. [col][prev|cur]
//   xv0   (B,2,d)    layer-0 gated output before fusion_v
//   hv    (L,B,2,2d) pre-gate vertical features
//   v2h   (L,B,2,2d)
//   xh    (L+1,B,2,d) horizontal input of each layer per column
//   xh0   (B,2,d)    layer-0 horizontal output before fusion_h
//   g     (B,d)      gated horizontal features
//   hid   (B,hid)    head hidden
//   lg    (B,K)      logits when they are not returned
//   bar   16 floats' room for the barrier counter
//   ops   the op list of one row
struct Scratch {
  float *ehist, *xs, *xv0, *hv, *v2h, *xh, *xh0, *g, *hid, *lg;
  unsigned int* bar;
  Op* ops;
};

constexpr int kScratchParts = 12;
void scratch_sizes(const Dims& m, long (&n)[kScratchParts]) {
  const long B = m.B, L = m.L, d = m.d;
  const long op_floats = (ops_per_row(m.L) * (long)sizeof(Op) + 63) / 64 * 16;
  const long sizes[kScratchParts] = {B * 2 * 3 * d, (L - 1) * B * 4 * d, B * 2 * d,
                                     L * B * 4 * d, L * B * 4 * d, (L + 1) * B * 2 * d,
                                     B * 2 * d, B * d, B * (long)m.hid, B * (long)m.K,
                                     16, op_floats};
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
  return Scratch{parts[0], parts[1], parts[2], parts[3], parts[4], parts[5],
                 parts[6], parts[7], parts[8], parts[9],
                 reinterpret_cast<unsigned int*>(parts[10]), reinterpret_cast<Op*>(parts[11])};
}

struct Tables {
  const void *wv0, *wvB, *wv2h, *wh, *wres, *wfv, *wfh, *w1, *w2, *emb;
  const float *bv, *bhsum, *br, *b1, *b2;
};

Op lin_op(const Lin& p, int gy = 1) {
  Op op{};
  op.kind = kOpLin; op.gy = gy; op.lin = p;
  return op;
}

Op gated_op(const Gated& p, int gy) {
  Op op{};
  op.kind = kOpGated; op.gy = gy; op.gated = p;
  return op;
}

#define TRY(expr)                           \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// Ops of one row with their dependencies; `schedule` puts each op in the
// phase after its latest dependency, so the vertical stack, v2h and column
// 0's horizontal pass overlap.  Every buffer has one writer per row and is
// read only by ops that depend on that writer (directly or through a chain),
// so ops sharing a phase never touch each other's outputs.
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

// The ops of one token row; row-dependent pointers move by their *_row strides.
template <typename T>
std::vector<Op> row_ops(const Dims& m, const Tables& t, const Scratch& s, const float* cls,
                        const float* audv, const float* audh, const float* noise,
                        uint64_t seed, const int* prefix, int prefix_len, int* tokens,
                        float* logits, int nw) {
  const long B = m.B, L = m.L, d = m.d, K = m.K, H = m.H, hid = m.hid;
  const long d2 = 2 * d, d4 = 4 * d;
  RowBuilder rb;
  int vert = 0, prev = -1;
  std::vector<int> v2h(m.L);
  auto v2h_op = [&](int l) {  // v2h of layer l, both columns (groups gy)
    Lin v{};
    v.w = static_cast<const T*>(t.wv2h) + l * d2 * d2; v.w_ld = d2;
    v.k0 = 0; v.klen = d2;
    v.x = s.hv + l * B * d4; v.x_ld = d4; v.x_gy = d2;
    v.y = s.v2h + l * B * d4; v.y_ld = d4; v.y_gy = d2;
    v.nout = d2; v.nb = m.B;
    return lin_op(v, 2);
  };
  // ---- vertical stack and v2h -------------------------------------------
  {  // layer 0: mask A over the 3 history rows -> hv[0], gate -> xv0
    Gated g{};
    g.w = t.wv0; g.w_ld = 6 * d; g.w_gy = d2 * 6 * d;
    g.k0 = 0; g.klen = 6 * d;
    g.x = s.ehist; g.x_ld = 6 * d;
    g.bias = t.bv;
    g.pre = s.hv; g.pre_ld = d4; g.pre_gy = d2;
    g.cls = cls; g.cls_ld = d2;
    g.out = s.xv0; g.out_ld = d2; g.out_gy = d;
    g.half = d; g.nb = m.B;
    vert = rb.add(gated_op(g, 2), {});
  }
  {  // fusion_v: x-part matmul + per-row audio term -> layer-1 current row
    Lin f{};
    f.w = t.wfv; f.w_ld = d; f.k0 = 0; f.klen = d;
    f.x = s.xv0; f.x_ld = d2; f.x_gy = d;
    f.add = audv; f.add_ld = H * d; f.add_row = d;
    f.y = s.xs + d; f.y_ld = d4; f.y_gy = d2;
    f.roll = s.xs;
    f.nout = d; f.nb = m.B;
    const int fv = rb.add(lin_op(f, 2), {vert});
    v2h[0] = rb.add(v2h_op(0), {vert});
    vert = fv;
  }
  for (int l = 1; l < m.L; ++l) {
    Gated g{};
    g.w = static_cast<const T*>(t.wvB) + (l - 1) * 2 * d2 * d4;
    g.w_ld = d4; g.w_gy = d2 * d4;
    g.k0 = 0; g.klen = d4;
    g.x = s.xs + (l - 1) * B * d4; g.x_ld = d4;
    g.bias = t.bv + l * d2;
    g.pre = s.hv + l * B * d4; g.pre_ld = d4; g.pre_gy = d2;
    if (l < m.L - 1) {
      g.cls = cls + l * B * d2; g.cls_ld = d2;
      g.out = s.xs + l * B * d4 + d; g.out_ld = d4; g.out_gy = d2;
      g.roll = s.xs + l * B * d4;
    }
    g.half = d; g.nb = m.B;
    vert = rb.add(gated_op(g, 2), {vert});
    v2h[l] = rb.add(v2h_op(l), {vert});
  }
  // ---- horizontal passes, column 0 then column 1 -------------------------
  for (int c = 0; c < 2; ++c) {
    for (int l = 0; l < m.L; ++l) {
      Gated g{};
      g.w = static_cast<const T*>(t.wh) + l * d2 * d2; g.w_ld = d2;
      if (c == 0) {  // self tap only; layer 0 (mask A) reads nothing at column 0
        g.k0 = d; g.klen = l == 0 ? 0 : d;
      } else {       // [left | self] taps; layer 0 has the left tap only (e0)
        g.k0 = 0; g.klen = l == 0 ? d : d2;
      }
      g.x = s.xh + l * B * d2; g.x_ld = d2;
      g.bias = t.bhsum + l * d2;
      g.add = s.v2h + l * B * d4 + c * d2; g.add_ld = d4;
      g.cls = cls + l * B * d2; g.cls_ld = d2;
      g.out = s.g; g.out_ld = d;
      g.half = d; g.nb = m.B;
      const int gated = prev < 0 ? rb.add(gated_op(g, 1), {v2h[l]})
                                 : rb.add(gated_op(g, 1), {v2h[l], prev});

      Lin r{};  // horiz_resid (+ residual for l > 0)
      r.w = static_cast<const T*>(t.wres) + l * d * d; r.w_ld = d;
      r.k0 = 0; r.klen = d;
      r.x = s.g; r.x_ld = d;
      r.bias = t.br + l * d;
      if (l > 0) { r.add = s.xh + l * B * d2 + c * d; r.add_ld = d2; }
      r.y = (l == 0 ? s.xh0 : s.xh + (l + 1) * B * d2) + c * d; r.y_ld = d2;
      r.nout = d; r.nb = m.B;
      prev = rb.add(lin_op(r), {gated});

      if (l == 0) {  // fusion_h before layer 1
        Lin f{};
        f.w = t.wfh; f.w_ld = d; f.k0 = 0; f.klen = d;
        f.x = s.xh0 + c * d; f.x_ld = d2;
        f.add = audh; f.add_ld = H * d; f.add_row = d;
        f.y = s.xh + B * d2 + c * d; f.y_ld = d2;
        f.nout = d; f.nb = m.B;
        prev = rb.add(lin_op(f), {prev});
      }
    }
    Lin h1{};  // head: relu(x @ w1 + b1)
    h1.w = t.w1; h1.w_ld = d; h1.k0 = 0; h1.klen = d;
    h1.x = s.xh + L * B * d2 + c * d; h1.x_ld = d2;
    h1.bias = t.b1; h1.relu = 1;
    h1.y = s.hid; h1.y_ld = hid;
    h1.nout = m.hid; h1.nb = m.B;
    prev = rb.add(lin_op(h1), {prev});

    // logits of (row, c): into the returned (B, H, 2, K) block, else scratch
    float* lg = logits ? logits + c * K : s.lg;
    const long lg_ld = logits ? H * 2 * K : K, lg_row = logits ? 2 * K : 0;
    Lin h2{};  // logits = hidden @ w2 + b2
    h2.w = t.w2; h2.w_ld = hid; h2.k0 = 0; h2.klen = m.hid;
    h2.x = s.hid; h2.x_ld = hid;
    h2.bias = t.b2;
    h2.y = lg; h2.y_ld = lg_ld; h2.y_row = lg_row;
    h2.nout = m.K; h2.nb = m.B;
    prev = rb.add(lin_op(h2), {prev});

    Sample sp{};
    sp.logits = lg; sp.logits_ld = lg_ld; sp.logits_row = lg_row;
    sp.noise = noise;
    sp.key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    sp.prefix = prefix; sp.prefix_len = prefix ? prefix_len : 0;
    sp.tokens = tokens;
    sp.emb = t.emb;
    sp.seed_out = s.xh; sp.seed_ld = d2;   // layer-0 input, column-0 slot
    sp.ehist = s.ehist;
    sp.B = m.B; sp.K = m.K; sp.H = m.H; sp.dim = m.d; sp.col = c;
    Op op{};
    op.kind = kOpSample; op.gy = 1; op.sample = sp;
    prev = rb.add(op, {prev});
  }
  return rb.schedule(nw);
}

template <typename T>
cudaError_t decode(const Dims& m, const Tables& t, const float* cls,
                   const float* audv, const float* audh, const float* noise,
                   uint64_t seed, const int* prefix, int prefix_len, int* tokens,
                   float* logits, float* scratch, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  TRY(cudaGetDevice(&dev));
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  TRY(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = ops_per_row(m.L) * sizeof(Op);
  TRY(cudaFuncSetAttribute(decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
  TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<T>, kThreads, smem));
  const int blocks = sms;   // one 512-thread block per SM: fewer arrivals per barrier
  if (per_sm < 1 || blocks < m.B) return cudaErrorCooperativeLaunchTooLarge;
  const Scratch s = carve(scratch, m);
  const std::vector<Op> ops = row_ops<T>(m, t, s, cls, audv, audh, noise, seed, prefix,
                                         prefix_len, tokens, logits, blocks * kWarps);
  if (static_cast<int>(ops.size()) != ops_per_row(m.L)) return cudaErrorInvalidValue;

  TRY(cudaMemsetAsync(scratch, 0, scratch_total(m) * sizeof(float), st));
  // pageable source: the copy is staged before this call returns
  TRY(cudaMemcpyAsync(s.ops, ops.data(), ops.size() * sizeof(Op), cudaMemcpyHostToDevice, st));
  const Op* ops_dev = s.ops;
  int nops = static_cast<int>(ops.size()), H = m.H;
  unsigned int* bar = s.bar;
  void* args[] = {&ops_dev, &nops, &H, &bar};
  TRY(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_kernel<T>),
                                  dim3(blocks), dim3(kThreads), args, smem, st));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of scratch that talkshow_ar_decode needs for these dimensions.
long long talkshow_ar_decode_scratch(int B, int L, int dim, int K, int hidden) {
  return scratch_total(Dims{B, 1, L, dim, K, hidden});
}

// Decode the (H, 2) token grid of B samples on `stream`.  table_dtype: 0 f32
// tables, 1 bf16 tables.  noise (H, 2, B, K) f32 or null for Philox keyed by
// `seed`.  prefix (B, H, 2) int32 or null.  logits (B, H, 2, K) or null.
// Returns the first CUDA error (0 on success); nothing here synchronises.
int talkshow_ar_decode(int table_dtype, int B, int H, int L, int dim, int K,
                       int hidden, const void* wv0, const void* wvB,
                       const void* wv2h, const void* wh, const void* wres,
                       const void* wfv, const void* wfh, const void* w1,
                       const void* w2, const void* emb, const float* bv,
                       const float* bhsum, const float* br, const float* b1,
                       const float* b2, const float* cls, const float* audv,
                       const float* audh, const float* noise,
                       unsigned long long seed, const int* prefix,
                       int prefix_len, int* tokens, float* logits,
                       float* scratch, void* stream) {
  const Dims m{B, H, L, dim, K, hidden};
  const Tables t{wv0, wvB, wv2h, wh, wres, wfv, wfh, w1, w2, emb,
                 bv, bhsum, br, b1, b2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (table_dtype == 0)
    e = decode<float>(m, t, cls, audv, audh, noise, seed, prefix, prefix_len,
                      tokens, logits, scratch, st);
  else if (table_dtype == 1)
    e = decode<__nv_bfloat16>(m, t, cls, audv, audh, noise, seed, prefix,
                              prefix_len, tokens, logits, scratch, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"

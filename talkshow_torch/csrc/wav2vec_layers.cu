// The wav2vec 2.0 post-norm encoder-layer stack (K2), for Hopper.
//
// Replaces the TPU kernel talkshow_tpu/models/wav2vec_pallas.py:_run_layers
// (:143, body _make_layer_kernel :99-139), which runs one layer per launch
// with the batch on the grid.  Per layer, on x (B, T, H) f32:
//   qkv = x Wqkv^T + bqkv                        (H -> 3H)
//   ctx = softmax(q k^T / sqrt(hd), keys >= valid_frames[b] at -1e30) v, per head
//   xn  = LN1(x + ctx Wo^T + bo)
//   x   = LN2(xn + gelu(xn W1^T + b1) W2^T + b2) (exact erf gelu)
// Both operands of every product are rounded to the table type (bf16 in
// production, f32 for exact comparison) and summed in f32, as the TPU
// kernel's dot does (:104-107); softmax, LayerNorm and gelu are f32.
//
// What bounds it on the card: at wav2vec 2.0 base (H 768, 12 heads, FFN
// 3072, 12 layers) and T = 300 frames, a B = 1 stack is ~54 GFLOP of
// products (~55 us at 989 TFLOP/s bf16) against ~170 MB of bf16 weights
// read once (~51 us at 3.35 TB/s): balanced at B = 1, operation-bound
// above.  The attention itself is ~0.3 GFLOP per layer.
//
// What the design does about it (bf16 tables):
// - The four products run on the Hopper GEMM of w2v_common.cuh (TMA ring,
//   wgmma, split-K where the grid would not fill the card) with bias,
//   gelu, the residual and the 1/sqrt(hd) scale of q fused into the
//   epilogue.
// - Every product rounds its A operand to bf16, so whatever feeds one is
//   stored in bf16 at no cost to the result: qkv (q already scaled, as the
//   plain version rounds q * scale), ctx, the FFN hidden layer, and a bf16
//   copy of each LayerNorm output beside the f32 one that the residual
//   needs (layer 0's input gets one cast pass).  Wo and W2 write f32, as
//   their residual sums are f32.
// - Attention on the tensor cores: one block per (64 queries, head, batch),
//   4 warps of 16 query rows; K and V tiles of 64 keys come from bf16 qkv
//   as TMA boxes into a 2-stage ring on mbarriers (per-thread cp.async
//   copies measured 1.5x slower at B = 1); S = Q K^T and O = P V are
//   mma.sync m16n8k16 with f32 sums.  The softmax is exact, not online:
//   pass 1 takes each row's max and sum of exp over recomputed score
//   tiles, pass 2 recomputes S, forms p = exp(s - max) / sum, rounds it to
//   bf16 (as the plain version rounds p) and accumulates P V.  exp is the
//   SFU's (~2^-21 relative over a softmax's range, far below p's bf16
//   rounding).  No (rows x T) buffer, so any clip length fits.  Keys at or
//   past valid_frames score -1e30; rows past it still attend to the valid
//   keys, so they stay finite.
// - LayerNorm: one warp per row, the row held in registers from 16-byte
//   loads for the mean, the variance and the output.
// f32 tables (the exact comparison mode) keep plain FMA products, the
// scalar attention below with its (16, T) score tile, and f32 buffers.

#include "w2v_common.cuh"

using namespace w2v;

namespace {

// ---- f32 tables: scalar attention --------------------------------------------

constexpr int kTQ = 16;           // query rows per attention block
constexpr int kTK = 64;           // keys per staged K or V tile
constexpr int kAttnThreads = 128;
constexpr int kMaxHd = 128;
constexpr int kDimGroups = kMaxHd / 16;   // head dims per thread in the P.V pass
constexpr int kKvLoads = kTK * kMaxHd / 4 / kAttnThreads;   // float4 loads per thread

// Rows [k0, k0 + nk) of one head's K or V (column offset `off` of qkv rows)
// into KV[kTK][hd + 1]; rows past nk are zero.  Every load of the tile is in
// flight before the first store, so their latencies overlap.
__device__ __forceinline__ void load_kv_tile(const float* base, int ld, int off, int k0, int nk,
                                             int hd, float* KV) {
  const int vpr = hd / 4, nvec = kTK * vpr;
  float4 r[kKvLoads];
#pragma unroll
  for (int j = 0; j < kKvLoads; ++j) {
    const int idx = threadIdx.x + j * kAttnThreads, row = idx / vpr;
    r[j] = idx < nvec && row < nk
               ? __ldg(reinterpret_cast<const float4*>(base + (size_t)(k0 + row) * ld + off +
                                                       (idx % vpr) * 4))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kKvLoads; ++j) {
    const int idx = threadIdx.x + j * kAttnThreads;
    if (idx < nvec) {
      float* dst = KV + (idx / vpr) * (hd + 1) + (idx % vpr) * 4;
      dst[0] = r[j].x;
      dst[1] = r[j].y;
      dst[2] = r[j].z;
      dst[3] = r[j].w;
    }
  }
}

size_t attn_f32_smem(int T, int hd) {
  return sizeof(float) * ((size_t)kTQ * T + (size_t)(kTQ + kTK) * (hd + 1));
}

// qkv (B, T, 3H) f32 = [q | k | v], head h at columns h*hd.  ctx (B, T, H).
__global__ void __launch_bounds__(kAttnThreads)
attention_f32_kernel(const float* qkv, const int* valid, float* ctx, int T, int H, int hd,
                     float scale) {
  extern __shared__ float sm[];
  float* S = sm;                       // [kTQ][T] scores, then probabilities
  float* Q = S + (size_t)kTQ * T;      // [kTQ][hd + 1]
  float* KV = Q + kTQ * (hd + 1);      // [kTK][hd + 1]
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ld = 3 * H, kvld = hd + 1;
  const float* base = qkv + (size_t)b * T * ld;
  const int tv = valid[b];
  const int nq = min(kTQ, T - q0);
  // each thread owns 2 query rows (r2, r2 + 1) and, per tile, 4 keys or 4+
  // head dims 16 apart (c16 + 16 j): 6 shared loads per 8 FMAs
  const int r2 = 2 * (tid / 16), c16 = tid % 16;

  for (int i = tid; i < kTQ * hd; i += kAttnThreads) {
    const int r = i / hd, d = i % hd;
    Q[r * kvld + d] = r < nq ? base[(size_t)(q0 + r) * ld + h * hd + d] * scale : 0.f;
  }
  for (int k0 = 0; k0 < T; k0 += kTK) {
    const int nk = min(kTK, T - k0);
    __syncthreads();
    load_kv_tile(base, ld, H + h * hd, k0, nk, hd, KV);
    __syncthreads();
    float s[2][4] = {};
    for (int d = 0; d < hd; ++d) {
      const float qa = Q[r2 * kvld + d], qb = Q[(r2 + 1) * kvld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float k = KV[(c16 + 16 * j) * kvld + d];
        s[0][j] = fmaf(qa, k, s[0][j]);
        s[1][j] = fmaf(qb, k, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c16 + 16 * j;
        if (c < nk) S[(size_t)(r2 + i) * T + k0 + c] = k0 + c < tv ? s[i][j] : -1e30f;
      }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kTQ; r += kAttnThreads / 32) {
    float* row = S + (size_t)r * T;
    float m = -INFINITY;
    for (int c = lane; c < T; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < T; c += 32) row[c] = row[c] / sum;
  }

  float o[2][kDimGroups] = {};
  for (int k0 = 0; k0 < T; k0 += kTK) {
    const int nk = min(kTK, T - k0);
    __syncthreads();
    load_kv_tile(base, ld, 2 * H + h * hd, k0, nk, hd, KV);
    __syncthreads();
    const float* pa = S + (size_t)r2 * T + k0;
    const float* pb = pa + T;
    for (int c = 0; c < nk; ++c) {
      const float p0 = pa[c], p1 = pb[c];
#pragma unroll
      for (int j = 0; j < kDimGroups; ++j) {
        if (c16 + 16 * j < hd) {
          const float v = KV[c * kvld + c16 + 16 * j];
          o[0][j] = fmaf(p0, v, o[0][j]);
          o[1][j] = fmaf(p1, v, o[1][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kDimGroups; ++j) {
      const int d = c16 + 16 * j;
      if (r2 + i < nq && d < hd) ctx[((size_t)b * T + q0 + r2 + i) * H + h * hd + d] = o[i][j];
    }
}

// ---- bf16 tables: tensor-core attention --------------------------------------

constexpr int kAttQ = 64;         // query rows per block: 4 warps x 16
constexpr int kAttK = 64;         // keys per staged tile
constexpr int kAttTcThreads = 128;
constexpr int kAttStages = 2;     // K (+ V) tiles in flight

template <int KB> struct AttTile {          // head dim padded to 16 KB
  static constexpr int kHdp = 16 * KB;
  static constexpr int kLd = kHdp + 8;      // 16-byte row pad: conflict-free ldmatrix
  static constexpr int kElems = kAttQ * kLd;
  static constexpr int kTiles = 1 + 2 * kAttStages;                 // Q, then (K, V) per stage
  static constexpr int kSmem = kTiles * kElems * (int)sizeof(bf16);
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of the hd columns at `off` of qkv rows into s; zeros past T.
template <int KB>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* base, int ld, int off, int r0,
                                          int T, int hd) {
  const int vpr = hd / 8;
  for (int idx = threadIdx.x; idx < kAttK * vpr; idx += kAttTcThreads) {
    const int r = idx / vpr, c = (idx % vpr) * 8;
    const bool ok = r0 + r < T;
    cp_async16(s + r * AttTile<KB>::kLd + c, ok ? base + (size_t)(r0 + r) * ld + off + c : base,
               ok);
  }
}

// qkv (B, T, 3H) bf16 = [q * scale | k | v], also as the tensor map tkv
// {3H, T, B} read in (64 rows x kLd) boxes; ctx (B, T, H) bf16.
template <int KB>
__global__ void __launch_bounds__(kAttTcThreads)
attention_tc_kernel(const __grid_constant__ CUtensorMap tkv, const bf16* qkv, const int* valid,
                    bf16* ctx, int T, int H, int hd) {
  using A = AttTile<KB>;
  constexpr int LD = A::kLd;
  extern __shared__ unsigned char att_raw[];
  __shared__ uint64_t full[kAttStages];
  bf16* att_sm = reinterpret_cast<bf16*>(att_raw + ((128 - (smem_u32(att_raw) & 127)) & 127));
  bf16* Qs = att_sm;
  const int q0 = blockIdx.x * kAttQ, h = blockIdx.y, b = blockIdx.z;
  const int ld = 3 * H, tv = valid[b];
  const bf16* base = qkv + (size_t)b * T * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // Q's head-dim padding [hd, 16 KB) stays zero (cp.async never writes it).
  // A K or V box is a whole padded row (kLd columns): past hd it holds the
  // next head's values or zeros past the row, and past T zeros, finite
  // either way, and Q's zeros (or p = 0) cancel them.
  const int pad = A::kHdp - hd;
  for (int idx = threadIdx.x; idx < kAttQ * pad; idx += kAttTcThreads)
    Qs[(idx / pad) * LD + hd + idx % pad] = __float2bfloat16_rn(0.f);
  load_rows<KB>(Qs, base, ld, h * hd, q0, T, hd);
  cp_async_commit();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kAttStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nt = (T + kAttK - 1) / kAttK;
  // step i < nt stages K tile i (pass 1); step nt + j stages K and V tile j
  // (pass 2); step i uses ring stage i % kAttStages.  Thread 0 issues them.
  const auto kv_stage = [&](int i) { return att_sm + (1 + 2 * (i % kAttStages)) * A::kElems; };
  const auto stage = [&](int i) {
    if (i >= 2 * nt) return;
    uint64_t* bar = &full[i % kAttStages];
    bf16* Ks = kv_stage(i);
    const int kt = i < nt ? i : i - nt;
    mbar_expect_tx(bar, (i < nt ? 1 : 2) * A::kElems * (unsigned)sizeof(bf16));
    tma_load_3d(Ks, &tkv, bar, H + h * hd, kt * kAttK, b);
    if (i >= nt) tma_load_3d(Ks + A::kElems, &tkv, bar, 2 * H + h * hd, kt * kAttK, b);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kAttStages; ++i) stage(i);

  uint32_t qf[KB][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[2 * KB][4];
#pragma unroll
  for (int j = 0; j < 2 * KB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < 2 * nt; ++i) {
    mbar_wait(&full[i % kAttStages], (i / kAttStages) & 1);   // step i's tiles have landed
    if (i == 0) {
      cp_async_wait<0>();
      __syncthreads();   // ... and every thread's share of Q
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        ldsm_x4(qf[kb], Qs + (warp * 16 + lane % 16) * LD + kb * 16 + (lane / 16) * 8);
    }
    const bf16* Ks = kv_stage(i);
    const int kt = i < nt ? i : i - nt;
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {   // keys 16 kp .. 16 kp + 15
        uint32_t kf[4];
        ldsm_x4(kf, Ks + (kp * 16 + lane % 8 + (lane / 16) * 8) * LD + kb * 16 + ((lane / 8) % 2) * 8);
        mma16816(s[2 * kp], qf[kb], kf[0], kf[1]);
        mma16816(s[2 * kp + 1], qf[kb], kf[2], kf[3]);
      }
    // s[nb][e]: row g + 8 (e / 2), key kt * 64 + 8 nb + 2 t + e % 2
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kAttK + 8 * nb + 2 * t + (e & 1);
        s[nb][e] = key >= T ? -INFINITY : key < tv ? s[nb][e] : -1e30f;
      }
    if (i < nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) sum += __expf(s[nb][2 * r] - mn) + __expf(s[nb][2 * r + 1] - mn);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * __expf(m[r] - mn) + sum;
        m[r] = mn;
      }
    } else {
      if (i == nt) inv_l[0] = 1.f / l[0], inv_l[1] = 1.f / l[1];
      const bf16* Vs = Ks + A::kElems;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // keys 16 kk .. 16 kk + 15
        uint32_t pa[4];   // p = exp(s - max) / sum, as softmax multiplies by 1 / sum
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* sv = s[2 * kk + q / 2];
          const int r = q % 2;
          pa[q] = pack_bf16(__expf(sv[2 * r] - m[r]) * inv_l[r], __expf(sv[2 * r + 1] - m[r]) * inv_l[r]);
        }
#pragma unroll
        for (int nd = 0; nd < KB; ++nd) {   // head dims 16 nd .. 16 nd + 15
          uint32_t vf[4];
          ldsm_x4_t(vf, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + nd * 16 + (lane / 16) * 8);
          mma16816(o[2 * nd], pa, vf[0], vf[1]);
          mma16816(o[2 * nd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // this step's buffers are free for step i + kAttStages
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage(i + kAttStages);
    }
  }

  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 2 * KB; ++j) {
    const int d = 8 * j + 2 * t;
    if (d >= hd) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (row + 8 * hh < T)
        *reinterpret_cast<__nv_bfloat162*>(ctx + ((size_t)b * T + row + 8 * hh) * H + h * hd + d) =
            __floats2bfloat162_rn(o[j][2 * hh], o[j][2 * hh + 1]);
  }
}

template <int KB>
int attention_tc(const bf16* qkv, const int* valid, bf16* ctx, int B, int T, int H, int heads,
                 cudaStream_t st) {
  constexpr int smem = AttTile<KB>::kSmem + 128;   // + alignment of the TMA boxes
  CUtensorMap tkv;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * H, (cuuint64_t)T, (cuuint64_t)B};
  const long long strides[2] = {3LL * H, 3LL * H * T};
  int e = encode_map(&tkv, qkv, 3, dims, strides, AttTile<KB>::kLd, kAttK, false);
  if (e != 0) return e;
  if ((e = cudaFuncSetAttribute(attention_tc_kernel<KB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return e;
  const dim3 grid((T + kAttQ - 1) / kAttQ, heads, B);
  attention_tc_kernel<KB><<<grid, kAttTcThreads, smem, st>>>(tkv, qkv, valid, ctx, T, H, H / heads);
  return cudaGetLastError();
}

int attention_bf16(const bf16* qkv, const int* valid, bf16* ctx, int B, int T, int H, int heads,
                   cudaStream_t st) {
  switch ((H / heads + 15) / 16) {
    case 1: return attention_tc<1>(qkv, valid, ctx, B, T, H, heads, st);
    case 2: return attention_tc<2>(qkv, valid, ctx, B, T, H, heads, st);
    case 3: return attention_tc<3>(qkv, valid, ctx, B, T, H, heads, st);
    case 4: return attention_tc<4>(qkv, valid, ctx, B, T, H, heads, st);
    case 5: return attention_tc<5>(qkv, valid, ctx, B, T, H, heads, st);
    case 6: return attention_tc<6>(qkv, valid, ctx, B, T, H, heads, st);
    case 7: return attention_tc<7>(qkv, valid, ctx, B, T, H, heads, st);
    case 8: return attention_tc<8>(qkv, valid, ctx, B, T, H, heads, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- LayerNorm and the input cast ---------------------------------------------

constexpr int kLnWarps = 4;       // rows (warps) per LayerNorm block
constexpr int kLnChunks = 8;      // float4s per lane: rows up to 1024 wide
constexpr int kMaxH = 32 * 4 * kLnChunks;

// y = LayerNorm(x) * gb[0:H] + gb[H:2H] over rows of width H, and its bf16
// copy yb unless null; one warp per row, the row in registers.
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_kernel(const float* x, const float* gb, float* y, bf16* yb, int M, int H, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int n4 = H / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * H);
  float4 v[kLnChunks];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kLnChunks; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  }
  const float mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kLnChunks; ++j) {
    if (lane + 32 * j < n4) {
      const float a = v[j].x - mean, b = v[j].y - mean, c = v[j].z - mean, d = v[j].w - mean;
      q = fmaf(a, a, fmaf(b, b, fmaf(c, c, fmaf(d, d, q))));
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
  const float4* gs = reinterpret_cast<const float4*>(gb);
  const float4* bs = reinterpret_cast<const float4*>(gb + H);
#pragma unroll
  for (int j = 0; j < kLnChunks; ++j) {
    const int c = lane + 32 * j;
    if (c >= n4) continue;
    const float4 gg = gs[c], bb = bs[c];
    const float4 r = make_float4((v[j].x - mean) * rstd * gg.x + bb.x,
                                 (v[j].y - mean) * rstd * gg.y + bb.y,
                                 (v[j].z - mean) * rstd * gg.z + bb.z,
                                 (v[j].w - mean) * rstd * gg.w + bb.w);
    reinterpret_cast<float4*>(y + (size_t)row * H)[c] = r;
    if (yb) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(yb + (size_t)row * H + 4 * c);
      p[0] = __floats2bfloat162_rn(r.x, r.y);
      p[1] = __floats2bfloat162_rn(r.z, r.w);
    }
  }
}

cudaError_t layernorm(const float* x, const float* gb, float* y, bf16* yb, int M, int H,
                      float eps, cudaStream_t st) {
  layernorm_kernel<<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(x, gb, y, yb, M, H,
                                                                             eps);
  return cudaGetLastError();
}

// y = bf16(x), n a multiple of 4
__global__ void cast_bf16_kernel(const float* x, bf16* y, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(y + 4 * i);
    p[0] = __floats2bfloat162_rn(v.x, v.y);
    p[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// ---- the stack ------------------------------------------------------------------

struct Dims {
  int B, T, H, heads, F, L;
  float eps;
};

struct Tables {
  const void *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *b1, *b2, *ln1, *ln2;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Layout {   // byte offsets into the scratch buffer
  size_t qkv, ctx, y, xn, xnb, hb, xb, total;
};

// f32 tables: f32 buffers.  bf16 tables: bf16 wherever a product reads the
// buffer next, f32 where a residual or LayerNorm does.
Layout layout(int dtype, int B, int T, int H, int F) {
  const size_t M = (size_t)B * T, es = dtype == 1 ? 2 : 4;
  Layout o{};
  size_t at = 0;
  const auto take = [&](size_t bytes) {
    const size_t off = at;
    at += align256(bytes);
    return off;
  };
  o.qkv = take(M * 3 * H * es);
  o.ctx = take(M * H * es);
  o.y = take(M * H * 4);
  o.xn = take(M * H * 4);
  o.hb = take(M * F * es);
  if (dtype == 1) {
    o.xnb = take(M * H * 2);
    o.xb = take(M * H * 2);
  }
  o.total = at;
  return o;
}

int run_f32(const Dims& d, const Tables& t, const int* valid, const float* x, float* out,
            char* scratch, cudaStream_t st) {
  const int B = d.B, T = d.T, H = d.H, F = d.F, hd = H / d.heads, M = B * T;
  const Layout lo = layout(0, B, T, H, F);
  float* qkv = reinterpret_cast<float*>(scratch + lo.qkv);
  float* ctx = reinterpret_cast<float*>(scratch + lo.ctx);
  float* y = reinterpret_cast<float*>(scratch + lo.y);
  float* xn = reinterpret_cast<float*>(scratch + lo.xn);
  float* hb = reinterpret_cast<float*>(scratch + lo.hb);
  const size_t smem = attn_f32_smem(T, hd);
  if (hd > kMaxHd || hd % 4 || smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 attn_grid((T + kTQ - 1) / kTQ, d.heads, B);
  const float scale = (float)(1.0 / sqrt((double)hd));
  const float* cur = x;
  for (int l = 0; l < d.L; ++l) {
    const float* wqkv = static_cast<const float*>(t.wqkv) + (size_t)l * 3 * H * H;
    const float* wo = static_cast<const float*>(t.wo) + (size_t)l * H * H;
    const float* w1 = static_cast<const float*>(t.w1) + (size_t)l * F * H;
    const float* w2 = static_cast<const float*>(t.w2) + (size_t)l * H * F;

    Epi ep{};
    ep.bias = t.bqkv + (size_t)l * 3 * H; ep.c = qkv; ep.ldc = 3 * H;
    if ((e = gemm_f32(FmaArgs{cur, H, 0, wqkv, M, 3 * H, H}, ep, 1, st)) != cudaSuccess) return e;

    attention_f32_kernel<<<attn_grid, kAttnThreads, smem, st>>>(qkv, valid, ctx, T, H, hd, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    ep = Epi{};
    ep.bias = t.bo + (size_t)l * H; ep.resid = cur; ep.ldr = H; ep.c = y; ep.ldc = H;
    if ((e = gemm_f32(FmaArgs{ctx, H, 0, wo, M, H, H}, ep, 1, st)) != cudaSuccess) return e;
    if ((e = layernorm(y, t.ln1 + (size_t)l * 2 * H, xn, nullptr, M, H, d.eps, st)) != cudaSuccess)
      return e;

    ep = Epi{};
    ep.bias = t.b1 + (size_t)l * F; ep.gelu = 1; ep.c = hb; ep.ldc = F;
    if ((e = gemm_f32(FmaArgs{xn, H, 0, w1, M, F, H}, ep, 1, st)) != cudaSuccess) return e;

    ep = Epi{};
    ep.bias = t.b2 + (size_t)l * H; ep.resid = xn; ep.ldr = H; ep.c = y; ep.ldc = H;
    if ((e = gemm_f32(FmaArgs{hb, F, 0, w2, M, H, F}, ep, 1, st)) != cudaSuccess) return e;
    if ((e = layernorm(y, t.ln2 + (size_t)l * 2 * H, out, nullptr, M, H, d.eps, st)) != cudaSuccess)
      return e;
    cur = out;
  }
  return cudaSuccess;
}

int run_bf16(const Dims& d, const Tables& t, const int* valid, const float* x, float* out,
             char* scratch, cudaStream_t st) {
  const int B = d.B, T = d.T, H = d.H, F = d.F, hd = H / d.heads, M = B * T;
  if (hd > kMaxHd || hd % 8) return cudaErrorInvalidValue;
  const Layout lo = layout(1, B, T, H, F);
  bf16* qkv = reinterpret_cast<bf16*>(scratch + lo.qkv);
  bf16* ctx = reinterpret_cast<bf16*>(scratch + lo.ctx);
  float* y = reinterpret_cast<float*>(scratch + lo.y);
  float* xn = reinterpret_cast<float*>(scratch + lo.xn);
  bf16* xnb = reinterpret_cast<bf16*>(scratch + lo.xnb);
  bf16* hb = reinterpret_cast<bf16*>(scratch + lo.hb);
  bf16* xb = reinterpret_cast<bf16*>(scratch + lo.xb);
  cast_bf16_kernel<<<std::min((M * H / 4 + 255) / 256, 1024), 256, 0, st>>>(x, xb,
                                                                            (long long)M * H / 4);
  int e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)hd));   // as the plain version's q * (1 / sqrt(hd))
  const float* cur = x;
  for (int l = 0; l < d.L; ++l) {
    const bf16* wqkv = static_cast<const bf16*>(t.wqkv) + (size_t)l * 3 * H * H;
    const bf16* wo = static_cast<const bf16*>(t.wo) + (size_t)l * H * H;
    const bf16* w1 = static_cast<const bf16*>(t.w1) + (size_t)l * F * H;
    const bf16* w2 = static_cast<const bf16*>(t.w2) + (size_t)l * H * F;

    Epi ep{};
    ep.bias = t.bqkv + (size_t)l * 3 * H; ep.c = qkv; ep.ldc = 3 * H;
    ep.scale_cols = H; ep.scale = scale;
    if ((e = gemm_bf16<bf16>(xb, H, 0, wqkv, M, 3 * H, H, 1, ep, st)) != 0) return e;

    if ((e = attention_bf16(qkv, valid, ctx, B, T, H, d.heads, st)) != 0) return e;

    ep = Epi{};
    ep.bias = t.bo + (size_t)l * H; ep.resid = cur; ep.ldr = H; ep.c = y; ep.ldc = H;
    if ((e = gemm_bf16<float>(ctx, H, 0, wo, M, H, H, 1, ep, st)) != 0) return e;
    if ((e = layernorm(y, t.ln1 + (size_t)l * 2 * H, xn, xnb, M, H, d.eps, st)) != cudaSuccess)
      return e;

    ep = Epi{};
    ep.bias = t.b1 + (size_t)l * F; ep.gelu = 1; ep.c = hb; ep.ldc = F;
    if ((e = gemm_bf16<bf16>(xnb, H, 0, w1, M, F, H, 1, ep, st)) != 0) return e;

    ep = Epi{};
    ep.bias = t.b2 + (size_t)l * H; ep.resid = xn; ep.ldr = H; ep.c = y; ep.ldc = H;
    if ((e = gemm_bf16<float>(hb, F, 0, w2, M, H, F, 1, ep, st)) != 0) return e;
    if ((e = layernorm(y, t.ln2 + (size_t)l * 2 * H, out, l + 1 < d.L ? xb : nullptr, M, H, d.eps,
                       st)) != cudaSuccess)
      return e;
    cur = out;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of scratch that talkshow_w2v_layers needs for these tables.
long long talkshow_w2v_layers_scratch(int table_dtype, int B, int T, int H, int F) {
  return (long long)layout(table_dtype, B, T, H, F).total;
}

// Run the L-layer stack on x (B, T, H) f32 into out (B, T, H) on `stream`.
// table_dtype: 0 f32 tables, 1 bf16 tables.  Matrices (L, out, in) of the
// table type; bqkv (L, 3H), bo (L, H), b1 (L, F), b2 (L, H), ln1/ln2
// (L, 2, H) f32; valid (B,) int32 on the device.  x and out may not alias.
// Returns the first CUDA error (0 on success; kErrTensorMap + a CUresult
// when a tensor map is refused); nothing here synchronises.
int talkshow_w2v_layers(int table_dtype, int B, int T, int H, int heads, int F, int L,
                        float eps, const void* wqkv, const void* wo, const void* w1,
                        const void* w2, const float* bqkv, const float* bo, const float* b1,
                        const float* b2, const float* ln1, const float* ln2, const int* valid,
                        const float* x, float* out, void* scratch, void* stream) {
  const Dims d{B, T, H, heads, F, L, eps};
  const Tables t{wqkv, wo, w1, w2, bqkv, bo, b1, b2, ln1, ln2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || heads < 1 || H % heads || H % 8 || F % 8 || H > kMaxH)
    return cudaErrorInvalidValue;
  char* s = static_cast<char*>(scratch);
  if (table_dtype == 0) return run_f32(d, t, valid, x, out, s, st);
  if (table_dtype == 1) return run_bf16(d, t, valid, x, out, s, st);
  return cudaErrorInvalidValue;
}

// The Hopper GEMM alone, for its test: c (z, M, N) f32 = A W^T with bf16 A
// (z, M, K) rows lda apart and batches a_batch apart, bf16 W (N, K).
// splits 0 lets the plan choose split-K; > 0 forces that many splits.
// talkshow_w2v_gemm_plan writes the plan (consumer warpgroups, splits, k
// tiles per split) to plan[0..2] (host memory).
void talkshow_w2v_gemm_plan(int M, int N, int K, int Z, int splits, int* plan) {
  const GemmPlan p = plan_gemm(M, N, K, Z, splits);
  plan[0] = p.wg;
  plan[1] = p.splits;
  plan[2] = p.kt_per;
}

int talkshow_w2v_gemm(const void* a, long long lda, long long a_batch, const void* w, int M,
                      int N, int K, int Z, int splits, float* c, void* stream) {
  Epi ep{};
  ep.c = c; ep.ldc = N; ep.c_batch = (long long)M * N;
  return gemm_bf16<float>(static_cast<const bf16*>(a), lda, a_batch, static_cast<const bf16*>(w),
                          M, N, K, Z, ep, static_cast<cudaStream_t>(stream), splits);
}

}  // extern "C"

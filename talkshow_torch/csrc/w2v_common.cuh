// Pieces shared by the wav2vec kernels K2 (wav2vec_layers.cu) and K3
// (wav2vec_extractor.cu): type conversions, exact gelu, warp reductions and
// one tiled GEMM with a fused epilogue.
//
// The GEMM computes C[z][m][n] = epi(sum_k A[z][m][k] * W[n][k]) for a batch
// of z.  A rows are K-contiguous with an arbitrary row stride, so a strided
// VALID conv over channels-last activations is the same GEMM with the row
// stride set to stride * C_in (rows overlap; no im2col copy).  W is
// output-major (N, K), as nn.Linear stores it, so both operands of a tile are
// K-contiguous.  Both operands are rounded to the table type TW when they are
// staged in shared memory and the sums are f32:
// - TW = bf16: mma.sync m16n8k16 bf16 tensor-core tiles with f32 accumulators,
//   block tile 64 x 64 x 64;
// - TW = f32: plain f32 FMAs (no TF32), so f32 tables give f32 results,
//   block tile 64 x 64 x 32.
// 4 warps per block.  Tiles travel raw (A in its own type) through a
// 4-stage cp.async ring in shared memory, so three tiles are in flight while
// one is multiplied; f32 A is rounded to bf16 when the mma fragments are
// read.  K, the row strides and the batch strides must be multiples of 8
// elements and the bases 16-byte aligned.
// The epilogue adds the bias, applies gelu, adds a residual and optionally
// rounds to bf16, in that order, and masks the ragged M / N edges.
// wgmma/TMA, ldmatrix and larger tiles for large M are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w2v {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (round to nearest even, as torch's .to() does), as f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kBM = 64, kBN = 64, kGemmThreads = 128;

template <typename TA, typename TW> struct GemmTile {
  static constexpr bool kMma = sizeof(TW) == 2;
  static constexpr int kBK = kMma ? 64 : 32;
  // row strides (elements): 16-byte multiples that keep the mma fragment
  // reads free of bank conflicts (f32 A: 8-byte pairs, bf16: 4-byte pairs)
  static constexpr int kLdA = kBK + (kMma ? 8 : 4);
  static constexpr int kLdW = kBK + (kMma ? 8 : 4);
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * kLdA * sizeof(TA);
  static constexpr int kStageBytes = kABytes + kBN * kLdW * sizeof(TW);
  static constexpr int kSmem = kStages * kStageBytes;
};

struct GemmArgs {
  const void* a;                // A (z, M, K) of TA, rows lda apart, batches a_batch apart
  long long lda, a_batch;
  const void* w;                // W (N, K) of TW, row-major
  const float* bias;            // (N) or null
  const float* resid;           // (M, N) f32 with row stride ldr, or null (batch 0 only)
  long long ldr;
  void* c;                      // C (z, M, N) of TO, rows ldc apart, batches c_batch apart
  long long ldc, c_batch;
  int M, N, K;
  int gelu;                     // exact gelu after the bias
  int round_bf16;               // round the result to bf16 before storing it
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T> __device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename TO>
__device__ __forceinline__ void emit(const GemmArgs& g, TO* C, int row, int col, float v) {
  if (row >= g.M || col >= g.N) return;
  if (g.bias) v += g.bias[col];
  if (g.gelu) v = gelu(v);
  if (g.resid) v += g.resid[row * g.ldr + col];
  if (g.round_bf16) v = round_to<bf16>(v);
  C[row * g.ldc + col] = from_f<TO>(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));   // 0 source bytes: the 16 bytes are zero-filled
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of a (ROWS x BK) tile of T, rows [row0, row0 + ROWS) and
// columns [k0, k0 + BK) of g, into s (row stride LD); out-of-range rows and
// columns become zeros.
template <typename T, int ROWS, int BK, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ld, int row0, int nrows,
                                          int k0, int K) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = BK / kVec, kN = ROWS * kPerRow / kGemmThreads;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int idx = threadIdx.x + j * kGemmThreads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const bool ok = row0 + r < nrows && k0 + c < K;
    cp_async16(s + r * LD + c, ok ? g + (row0 + r) * ld + k0 + c : g, ok);
  }
}

// Two consecutive A values of a fragment, as packed bf16 (low half first).
__device__ __forceinline__ uint32_t frag2(const bf16* p) { return ld32(p); }
__device__ __forceinline__ uint32_t frag2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename TA, typename TW, typename TO>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  using Tile = GemmTile<TA, TW>;
  constexpr int BK = Tile::kBK, LDA = Tile::kLdA, LDW = Tile::kLdW, S = Tile::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const TA* A = static_cast<const TA*>(g.a) + blockIdx.z * g.a_batch;
  const TW* W = static_cast<const TW*>(g.w);
  TO* C = static_cast<TO*>(g.c) + blockIdx.z * g.c_batch;
  const auto a_stage = [&](int st) {
    return reinterpret_cast<TA*>(smem + st * Tile::kStageBytes);
  };
  const auto w_stage = [&](int st) {
    return reinterpret_cast<TW*>(smem + st * Tile::kStageBytes + Tile::kABytes);
  };
  const auto fetch = [&](int kt) {
    const int st = kt % S;
    load_tile<TA, kBM, BK, LDA>(a_stage(st), A, g.lda, m0, g.M, kt * BK, g.K);
    load_tile<TW, kBN, BK, LDW>(w_stage(st), W, g.K, n0, g.N, kt * BK, g.K);
  };

  float acc[32];   // SIMT: 8 rows x 4 cols; mma: 2 x 4 fragments of 4
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int nk = (g.K + BK - 1) / BK;
#pragma unroll
  for (int kt = 0; kt < S - 1; ++kt) {
    if (kt < nk) fetch(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();            // tile kt has landed
    __syncthreads();                   // ... for every thread; stage (kt - 1) % S is free
    if (kt + S - 1 < nk) fetch(kt + S - 1);
    cp_async_commit();
    const TA* as = a_stage(kt % S);
    const TW* ws = w_stage(kt % S);
    if constexpr (Tile::kMma) {
      const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
      const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const TA* p = as + (wm + mi * 16 + gq) * LDA + ks + 2 * t4;
          a[mi][0] = frag2(p);
          a[mi][1] = frag2(p + 8 * LDA);
          a[mi][2] = frag2(p + 8);
          a[mi][3] = frag2(p + 8 * LDA + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const TW* p = ws + (wn + ni * 8 + gq) * LDW + ks + 2 * t4;
          b[ni][0] = ld32(p);
          b[ni][1] = ld32(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(&acc[(mi * 4 + ni) * 4], a[mi], b[ni]);
      }
    } else {
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], w[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f(as[(ty + 8 * i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = to_f(ws[(tx + 16 * j) * LDW + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], w[j], acc[i * 4 + j]);
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (Tile::kMma) {
    const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* c = &acc[(mi * 4 + ni) * 4];
        const int r = m0 + wm + mi * 16 + gq, col = n0 + wn + ni * 8 + 2 * t4;
        emit(g, C, r, col, c[0]);
        emit(g, C, r, col + 1, c[1]);
        emit(g, C, r + 8, col, c[2]);
        emit(g, C, r + 8, col + 1, c[3]);
      }
  } else {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) emit(g, C, m0 + ty + 8 * i, n0 + tx + 16 * j, acc[i * 4 + j]);
  }
}

template <typename TA, typename TW, typename TO>
cudaError_t gemm(const GemmArgs& g, int batches, cudaStream_t st) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (g.K % 8 || g.lda % 8 || g.a_batch % 8 || misaligned(g.a) || misaligned(g.w))
    return cudaErrorInvalidValue;
  constexpr int smem = GemmTile<TA, TW>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<TA, TW, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, batches);
  gemm_kernel<TA, TW, TO><<<grid, kGemmThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace w2v

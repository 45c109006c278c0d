// Pieces shared by the wav2vec kernels K2 (wav2vec_layers.cu) and K3
// (wav2vec_extractor.cu): type conversions, exact gelu, warp reductions and
// one GEMM with a fused epilogue, in two forms.
//
// The GEMM computes C[z][m][n] = epi(sum_k A[z][m][k] * W[n][k]) for a batch
// of z.  A rows are K-contiguous with an arbitrary row stride, so a strided
// VALID conv over channels-last activations is the same GEMM with the row
// stride set to stride * C_in (rows overlap; no im2col copy).  W is
// output-major (N, K), as nn.Linear stores it, so both operands of a tile are
// K-contiguous.  The sums are f32.  The epilogue adds the bias, scales the
// first `scale_cols` columns, applies gelu, adds a residual and optionally
// rounds to bf16, in that order, and masks the ragged M / N edges.
//
// - bf16 operands (production): `gemm_bf16`, one warp-specialised Hopper
//   kernel.  A producer warp streams (BM x 64) A tiles and (128 x 64) W
//   tiles with TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of
//   4-5 shared-memory stages that complete on mbarriers; one or two consumer
//   warpgroups run wgmma.mma_async m64n128k16 with both operands read from
//   shared memory and the sums in registers.  A is a 3-D tensor map
//   {K, M, Z} with strides {lda, a_batch}: out-of-range rows and k columns
//   arrive as zeros, so ragged edges and the overlapping conv rows need no
//   masking in the main loop.  The maps hold pointers, so the host encodes
//   them per call (cuTensorMapEncodeTiled, reached through the runtime's
//   driver entry point; no libcuda link).
//   The code picks the tile (64 or 128 rows) and split-K from (M, N, K, z)
//   so that the grid fills the card.  The splits of one output tile are one
//   thread-block cluster: each leaves its f32 partial tile in its shared
//   memory, and after a cluster barrier each sums a share of the tile over
//   all splits through distributed shared memory, in split order, so a
//   rerun is bit-equal (no float atomics, no workspace).
// - f32 operands (exact comparison mode): `gemm_f32`, plain f32 FMAs (no
//   TF32) on a 64 x 64 x 32 tile fed by a 4-stage cp.async ring.  It is
//   right, not fast; no bf16 path falls back to it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));   // 0 source bytes: the 16 bytes are zero-filled
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What happens to a sum on its way out (see the top of this file).
struct Epi {
  const float* bias;            // (N) or null
  const float* resid;           // (M, N) f32 with row stride ldr, or null (batch 0 only)
  long long ldr;
  void* c;                      // C (z, M, N), rows ldc apart, batches c_batch apart
  long long ldc, c_batch;
  int gelu;                     // exact gelu after the bias
  int round_bf16;               // round the result to bf16 before storing it
  int scale_cols;               // columns [0, scale_cols) are multiplied by scale
  float scale;                  // ... after the bias
};

__device__ __forceinline__ float epi_value(const Epi& e, long long row, int col, float v) {
  if (e.bias) v += e.bias[col];
  if (col < e.scale_cols) v *= e.scale;
  if (e.gelu) v = gelu(v);
  if (e.resid) v += e.resid[row * e.ldr + col];
  if (e.round_bf16) v = round_to<bf16>(v);
  return v;
}

// ---------------------------------------------------------------------------
// f32 tables: plain FMAs
// ---------------------------------------------------------------------------

constexpr int kFmaBM = 64, kFmaBN = 64, kFmaBK = 32, kFmaThreads = 128, kFmaStages = 4;
constexpr int kFmaLd = kFmaBK + 4;   // row stride in floats: 16-byte rows, no bank conflicts
constexpr int kFmaStageFloats = (kFmaBM + kFmaBN) * kFmaLd;
constexpr int kFmaSmem = kFmaStages * kFmaStageFloats * sizeof(float);

struct FmaArgs {
  const float* a;               // A (z, M, K), rows lda apart, batches a_batch apart
  long long lda, a_batch;
  const float* w;               // W (N, K), row-major
  int M, N, K;
};

// Start the copies of a (64 x 32) f32 tile, rows [row0, row0 + 64) and
// columns [k0, k0 + 32) of g, into s; out-of-range rows and columns are zeros.
__device__ __forceinline__ void fma_load_tile(float* s, const float* g, long long ld, int row0,
                                              int nrows, int k0, int K) {
  constexpr int kPerRow = kFmaBK / 4, kN = kFmaBM * kPerRow / kFmaThreads;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int idx = threadIdx.x + j * kFmaThreads;
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    const bool ok = row0 + r < nrows && k0 + c < K;
    cp_async16(s + r * kFmaLd + c, ok ? g + (row0 + r) * ld + k0 + c : g, ok);
  }
}

__global__ void __launch_bounds__(kFmaThreads) fma_gemm_kernel(FmaArgs g, Epi e) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFmaBM, n0 = blockIdx.x * kFmaBN;
  const float* A = g.a + blockIdx.z * g.a_batch;
  const auto fetch = [&](int kt) {
    float* s = fsm + (kt % kFmaStages) * kFmaStageFloats;
    fma_load_tile(s, A, g.lda, m0, g.M, kt * kFmaBK, g.K);
    fma_load_tile(s + kFmaBM * kFmaLd, g.w, g.K, n0, g.N, kt * kFmaBK, g.K);
  };
  float acc[32];   // 8 rows x 4 cols
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int nk = (g.K + kFmaBK - 1) / kFmaBK;
#pragma unroll
  for (int kt = 0; kt < kFmaStages - 1; ++kt) {
    if (kt < nk) fetch(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFmaStages - 2>();   // tile kt has landed
    __syncthreads();                   // ... for every thread; stage (kt - 1) % S is free
    if (kt + kFmaStages - 1 < nk) fetch(kt + kFmaStages - 1);
    cp_async_commit();
    const float* as = fsm + (kt % kFmaStages) * kFmaStageFloats;
    const float* ws = as + kFmaBM * kFmaLd;
#pragma unroll 4
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[8], w[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty + 8 * i) * kFmaLd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[(tx + 16 * j) * kFmaLd + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(a[i], w[j], acc[i * 4 + j]);
    }
  }
  cp_async_wait<0>();
  float* C = static_cast<float*>(e.c) + blockIdx.z * e.c_batch;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 8 * i, col = n0 + tx + 16 * j;
      if (row < g.M && col < g.N) C[row * e.ldc + col] = epi_value(e, row, col, acc[i * 4 + j]);
    }
}

// C = epi(A W^T) with f32 operands; `batches` z.
inline cudaError_t gemm_f32(const FmaArgs& g, const Epi& e, int batches, cudaStream_t st) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (g.K % 4 || g.lda % 4 || g.a_batch % 4 || misaligned(g.a) || misaligned(g.w))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fma_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFmaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + kFmaBN - 1) / kFmaBN, (g.M + kFmaBM - 1) / kFmaBM, batches);
  fma_gemm_kernel<<<grid, kFmaThreads, kFmaSmem, st>>>(g, e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 operands: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kBK = 64;              // k per stage: 64 bf16 = 128 bytes, one swizzle row
constexpr int kBN = 128;             // output columns per block: one m64n128k16 per 16 k
constexpr int kSMs = 132;            // H100 SXM; a fixed plan, so every card runs the same sums
constexpr int kErrTensorMap = 10000; // + CUresult: cuTensorMapEncodeTiled refused a map

template <int WG> struct WgTile {    // WG consumer warpgroups of 64 rows each
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * WG + 32;   // + one producer warp
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBN * kBK * 2;
  // 4 stages (96 KB) let two 64-row blocks share an SM; 5 for 128 rows
  static constexpr int kStages = WG == 1 ? 4 : 5;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

struct GemmPlan {
  int wg;               // consumer warpgroups: 64 * wg rows per tile
  int splits, kt_per;   // split-K: split s takes k tiles [s kt_per, (s + 1) kt_per)
};

// 128-row tiles once they alone give a wave; else 64-row tiles, and when
// those leave half the card idle, split K, keeping >= 12 k tiles a split
// (a split costs a cluster barrier and a pass over the tile; shorter splits
// measured no faster) and <= 8 splits, a portable cluster.  force_splits > 0
// sets the split count (the GEMM's own test), up to 8.
inline GemmPlan plan_gemm(int M, int N, int K, int Z, int force_splits) {
  const long long nk = (K + kBK - 1) / kBK, nt = (N + kBN - 1) / kBN;
  GemmPlan p;
  const long long big = (M + 127LL) / 128 * nt * Z;
  p.wg = big >= kSMs ? 2 : 1;
  const long long tiles = p.wg == 2 ? big : (M + 63LL) / 64 * nt * Z;
  long long s = 1;
  if (force_splits > 0)
    s = force_splits;
  else if (tiles < kSMs / 2)
    s = std::min(kSMs / tiles, nk / 12);
  s = std::max(1LL, std::min(std::min(s, nk), 8LL));
  p.kt_per = (int)((nk + s - 1) / s);   // no split is left empty
  p.splits = (int)((nk + p.kt_per - 1) / p.kt_per);
  return p;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t addr, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait until the phase of parity `parity` has completed; a wait past 10 s
// means a lost copy, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const uint32_t a = smem_u32(b);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory descriptor of a K-major tile of 128-byte rows in TMA's
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) B^T (16 x 128), both K-major bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// 16 bytes at p's offset in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ float4 ld_cluster4(const float* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

template <typename TO>
__device__ __forceinline__ void store4(TO* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// epi_value on columns col .. col + 3 of one row, with 16-byte loads.
__device__ __forceinline__ float4 epi_value4(const Epi& e, long long row, int col, float4 v) {
  if (e.bias) {
    const float4 b = *reinterpret_cast<const float4*>(e.bias + col);
    v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  }
  if (col < e.scale_cols) v = make_float4(v.x * e.scale, v.y * e.scale, v.z * e.scale, v.w * e.scale);
  if (e.gelu) v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
  if (e.resid) {
    const float4 r = *reinterpret_cast<const float4*>(e.resid + row * e.ldr + col);
    v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
  }
  if (e.round_bf16)
    v = make_float4(round_to<bf16>(v.x), round_to<bf16>(v.y), round_to<bf16>(v.z), round_to<bf16>(v.w));
  return v;
}

struct WgArgs {
  Epi e;
  int M, N, K;
  int splits, kt_per;   // split-K: `splits` CTAs of one cluster share an output tile
};

template <int WG, typename TO>
__global__ void __launch_bounds__(WgTile<WG>::kThreads)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                  const WgArgs g) {
  using T = WgTile<WG>;
  constexpr int S = T::kStages, kConsumers = 128 * WG;
  extern __shared__ unsigned char wsm_raw[];
  unsigned char* smem = wsm_raw + ((1024 - (smem_u32(wsm_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::kStageBytes);
  uint64_t* empty = full + S;
  const int nk = (g.K + kBK - 1) / kBK;
  const int zi = blockIdx.z / g.splits, split = blockIdx.z % g.splits;
  const int kb = split * g.kt_per, ke = min(nk, kb + g.kt_per);
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {   // the producer warp: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = kb; kt < ke; ++kt) {
        const int i = kt - kb, s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* st = smem + s * T::kStageBytes;
        tma_load_3d(st, &ta, &full[s], kt * kBK, m0, zi);
        tma_load_2d(st + T::kABytes, &tw, &full[s], kt * kBK, n0);
      }
    }
    if (g.splits > 1) {   // the warp keeps the cluster's two barriers with the consumers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  // one k tile's products stay in flight while the next tile's are issued;
  // a stage goes back to the producer once its products are done
  for (int kt = kb, prev = -1; kt < ke; ++kt) {
    const int i = kt - kb, s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const unsigned char* a = smem + s * T::kStageBytes + wg * 64 * kBK * 2;
    const unsigned char* w = smem + s * T::kStageBytes + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) wgmma_m64n128k16(acc, sw128_desc(a + 32 * k), sw128_desc(w + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // The sums go through shared memory (the ring is free once every consumer
  // is past its last k tile), so that bias, residual and C move in whole
  // 16-byte row segments.  Accumulator layout of m64nNk16: warp w of the
  // group holds rows 16w..16w+15; d[4j + 2h + i] is row lane/4 + 8h, column
  // 8j + 2(lane%4) + i.
  constexpr int LDT = kBN + 4, kTile4 = T::kBM * kBN / 4;
  float* tile = reinterpret_cast<float*>(smem);
  const int ct = threadIdx.x;
  consumer_sync(kConsumers);
  {
    const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (r + 8 * h) * LDT + 8 * j + 2 * (lane % 4)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  // Split-K: the splits of a tile are one cluster.  After a cluster barrier,
  // split q sums its share [lo, hi) of the tile's float4s over every split's
  // shared tile, in split order, and stores it; a second barrier keeps each
  // tile alive until its peers have read it.
  const int lo = split * kTile4 / g.splits, hi = (split + 1) * kTile4 / g.splits;
  if (g.splits > 1)
    cluster_sync();
  else
    consumer_sync(kConsumers);
  TO* C = static_cast<TO*>(g.e.c) + zi * g.e.c_batch;
  for (int idx = lo + ct; idx < hi; idx += kConsumers) {
    const int r = idx / (kBN / 4), c = 4 * (idx % (kBN / 4));
    const int row = m0 + r, col = n0 + c;
    if (row >= g.M || col >= g.N) continue;
    float4 v;
    if (g.splits > 1) {
      v = ld_cluster4(tile + r * LDT + c, 0);
      for (int sp = 1; sp < g.splits; ++sp) {
        const float4 u = ld_cluster4(tile + r * LDT + c, sp);
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
    } else {
      v = *reinterpret_cast<const float4*>(tile + r * LDT + c);
    }
    store4<TO>(C + (long long)row * g.e.ldc + col, epi_value4(g.e, row, col, v));
  }
  if (g.splits > 1) cluster_sync();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first) read in (cols x rows)
// boxes (one deep along a third dim), zeros out of range; 128-byte swizzle
// for the GEMM's wgmma operands, none for plain row-major tiles.  Strides
// in elements (dims 1..).
inline int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                      const long long* strides, cuuint32_t cols, cuuint32_t rows, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return kErrTensorMap + CUDA_ERROR_NOT_FOUND;
  cuuint64_t bstrides[2];
  for (int i = 0; i + 1 < rank; ++i) bstrides[i] = (cuuint64_t)strides[i] * sizeof(bf16);
  const cuuint32_t box[3] = {cols, rows, 1}, estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        bstrides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

template <int WG, typename TO>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tw, const WgArgs& g, dim3 grid,
                 cudaStream_t st) {
  constexpr int smem = WgTile<WG>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(wgmma_gemm_kernel<WG, TO>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WgTile<WG>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wgmma_gemm_kernel<WG, TO>, ta, tw, g);
}

// C = epi(A W^T), bf16 A (z, M, K) with rows lda apart and batches a_batch
// apart, bf16 W (N, K), C of TO.  Returns a cudaError_t, or kErrTensorMap +
// the CUresult when a tensor map is refused.
template <typename TO>
int gemm_bf16(const bf16* a, long long lda, long long a_batch, const bf16* w, int M, int N,
              int K, int Z, const Epi& e, cudaStream_t st, int force_splits = 0) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || Z < 1 || K % 8 || N % 8 || lda % 8 || a_batch % 8 || misaligned(a) ||
      misaligned(w))
    return cudaErrorInvalidValue;
  const GemmPlan p = plan_gemm(M, N, K, Z, force_splits);
  CUtensorMap ta, tw;
  const cuuint64_t adims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)Z};
  const long long astr[2] = {lda, Z > 1 ? a_batch : lda * M};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const long long wstr[1] = {K};
  int r = encode_map(&ta, a, 3, adims, astr, kBK, 64 * p.wg, true);
  if (r == 0) r = encode_map(&tw, w, 2, wdims, wstr, kBK, kBN, true);
  if (r != 0) return r;
  const WgArgs g{e, M, N, K, p.splits, p.kt_per};
  const dim3 grid((N + kBN - 1) / kBN, (M + 64 * p.wg - 1) / (64 * p.wg), Z * p.splits);
  return p.wg == 2 ? launch_wgmma<2, TO>(ta, tw, g, grid, st)
                   : launch_wgmma<1, TO>(ta, tw, g, grid, st);
}

}  // namespace w2v

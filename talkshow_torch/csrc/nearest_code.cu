// Nearest-code search of the EMA vector quantizer (K4), for Hopper.
//
// Replaces the TPU kernel talkshow_tpu/ops/vq.py:nearest_code_pallas (:72,
// call :87, body _nearest_code_kernel :62-68): for rows x (N, D) f32 and a
// codebook E (K, D) f32,
//   idx[n] = argmin_k fmaf(-2, x_n . e_k, ||e_k||^2)
// (||x_n||^2 is the same for every k and left out, as in JAX), the lowest k
// winning a tie, as jnp.argmin and torch.argmin pick it.  The output is
// int64, ready for torch indexing.
//
// What bounds it on the card: at the training shape (N = 128 * 88 / 4 =
// 2816 rows per quantizer, K = 2048, D = 64) it reads 0.72 MB of rows and
// 0.52 MB of codebook and writes 22 KB of indices (~0.4 us at 3.35 TB/s),
// and does 2 * N * K * D = 0.74 GFLOP: ~11 us at the f32 peak outside the
// tensor cores (67 TFLOP/s).  The sums stay in f32 FMAs (no TF32), so the
// distances are the plain f32 version's up to summation order:
// operation-bound on the f32 pipes.  At N = 75 (one clip) the work is a
// few us of one launch: latency-bound.
//
// What the design does about it: one launch per call, and no scratch.
// - A tile of x rows meets the whole codebook on one thread-block cluster:
//   CTA q of the cluster takes the code slice [q * slice, (q + 1) * slice)
//   into shared memory (256 codes, 64 KB, at a time), with the tile's rows
//   beside it.  The host's plan (kernels/nearest_code.py:search_plan) sizes
//   the tiles, the cluster and the passes from (N, K, D) so that the grid
//   fills the card and fits on it at once: 64-row tiles x 4 CTAs of two
//   256-code passes at N = 2816 (176 CTAs), 8-row tiles x 16 CTAs of 128
//   codes at N = 75 (160 CTAs).
// - One thread issues the slice and the rows as TMA boxes of 16 depth
//   values (64 bytes a row, 64-byte swizzle), one mbarrier per box pair,
//   all at once: no other thread spends an instruction on a copy, and the
//   products of the first 16 depths start as soon as they land.  The
//   swizzle puts the 8 codes (or 4 rows) that a warp's lanes read at one
//   depth in distinct banks.
// - Each warp is 4 x 8 lanes over rows x codes; a thread keeps an 8-row x
//   16-code register tile (2 x 2 for the 8-row tiles) and per depth quad
//   reads its rows and codes with 16-byte shared loads: 24 loads for 512
//   FMAs.  Each (row, code) dot product is one f32 FMA chain in depth
//   order; ||e_k||^2 is the same chain over the resident code, so the
//   wrapper launches nothing else.
// - A thread visits its codes in ascending order and keeps, per row, the
//   first code of least distance (a strict <, so an exact tie keeps the
//   lower index, and -0.0 ties +0.0; a NaN distance is never taken over a
//   number).  Then each row's winner becomes one 64-bit key, the distance's
//   bits made order-preserving in the high word and the code in the low
//   word; keys are unique and their minimum does not depend on the order it
//   is taken in, so reruns are bit-equal.  Lanes reduce by shuffles; every
//   warp then stores its keys of row r into the shared memory of the
//   cluster's CTA r mod C (DSMEM), and after one cluster barrier that CTA
//   takes the least key of each of its rows and writes the int64 index.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 64;
constexpr int kMaxCluster = 16;    // non-portable above 8
constexpr int kGroupDepth = 16;    // depth values of a TMA box: 64-byte rows
constexpr int kAlign = 1024;       // shared buffers start on a swizzle-pattern boundary
constexpr int kErrTensorMap = 10000;   // + CUresult: cuTensorMapEncodeTiled refused a map

// TM x TN: a thread's rows x codes; WR x WC: the CTA's warps over rows x
// codes, each warp 4 x 8 lanes.
template <int TM, int TN, int WR, int WC>
struct Tile {
  static constexpr int kThreads = 32 * WR * WC;
  static constexpr int kRowThreads = 4 * WR, kCodeThreads = 8 * WC;
  static constexpr int kRows = kRowThreads * TM;     // x rows of a tile
  static constexpr int kCodes = kCodeThreads * TN;   // codes a CTA holds at once
  // the keys a CTA receives: one per (cluster rank, warp column, row)
  static constexpr int kSlots = kMaxCluster * WC * kRows;
  // bytes of one 16-depth box of the codes and of the rows
  static constexpr int kCodeBox = kCodes * 64;
  static constexpr int kRowBox = (kRows * 64 + kAlign - 1) / kAlign * kAlign;
};

__host__ __device__ constexpr int groups_of(int D) { return (D + kGroupDepth - 1) / kGroupDepth; }

// kernels/nearest_code.py:search_plan repeats this sum for its checks
template <class T>
__host__ __device__ constexpr int smem_bytes(int D) {
  return kAlign + groups_of(D) * (T::kCodeBox + T::kRowBox) + T::kCodes * 4 + T::kSlots * 8 +
         groups_of(D) * 8;
}

// 16-byte quad `ch` (0..3) of row r in a box of 64-byte rows, as TMA's
// 64-byte swizzle stores it: the quad index XOR bits 1-2 of the row
__device__ __forceinline__ const float4* quad(const float* box, int r, int ch) {
  return reinterpret_cast<const float4*>(box + r * kGroupDepth + ((ch ^ ((r >> 1) & 3)) << 2));
}

// IEEE bits -> unsigned order: flip all bits of negatives, the sign of
// positives; -0.0 counts as +0.0, as torch.argmin compares them.
__device__ __forceinline__ unsigned long long pack_key(float dist, int code) {
  unsigned int b = dist == 0.f ? 0u : __float_as_uint(dist);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned int>(code);
}

__device__ __forceinline__ unsigned long long umin(unsigned long long a, unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(b)), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  int64_t* idx;        // (N,)
  int N, K, D;         // D % 4 == 0
  int slice;           // codes per CTA of a cluster
};

template <int TM, int TN, int WR, int WC>
__global__ void __launch_bounds__(Tile<TM, TN, WR, WC>::kThreads, 2)
search_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap te,
              const Args a) {
  using T = Tile<TM, TN, WR, WC>;
  constexpr int R = T::kRows, S = T::kCodes, kThreads = T::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (kAlign - smem_u32(smem_raw) % kAlign) % kAlign;
  const int quads = a.D / 4;
  const int groups = groups_of(a.D);
  float* es = reinterpret_cast<float*>(base);                          // [group][S][16]
  float* xs = reinterpret_cast<float*>(base + groups * T::kCodeBox);   // [group][R][16]
  float* e2s = reinterpret_cast<float*>(base + groups * (T::kCodeBox + T::kRowBox));
  auto* slots = reinterpret_cast<unsigned long long*>(e2s + S);        // [rank][wc][row]
  auto* bars = reinterpret_cast<uint64_t*>(slots + T::kSlots);         // one per group

  // every CTA of the cluster has started before any writes into another's
  // shared memory: arrive now, wait just before the first remote store
  cluster_arrive_relaxed();
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int row0 = static_cast<int>(blockIdx.x) / C * R;
  const int kbeg = rank * a.slice;
  const int kend = min(a.K, kbeg + a.slice);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp % WC;
  const int tr = warp / WC * 4 + (lane >> 3);  // rows tr + i * kRowThreads
  const int tc = wc * 8 + (lane & 7);          // codes tc + j * kCodeThreads
  // float offsets of row tr's and code tc's first quad in a swizzled box
  const int xsw = tr * kGroupDepth + (((tr >> 1) & 3) << 2);
  const int esw = tc * kGroupDepth + (((tc >> 1) & 3) << 2);

  if (tid == 0) {
    for (int g = 0; g < groups; ++g) mbar_init(&bars[g]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float bd[TM];                                // per row: least distance, its code
  int bk[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bd[i] = __int_as_float(0x7f800000);        // +inf
    bk[i] = kbeg;
  }

  // the slice in passes of S codes
  unsigned parity = 0;
  for (int k0 = kbeg; k0 < kend; k0 += S, parity ^= 1) {
    const int nc = min(S, kend - k0);
    if (k0 != kbeg) __syncthreads();           // the last pass's codes are read
    if (tid == 0) {
      // codes before rows; rows past N or K arrive as zeros
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int g = 0; g < groups; ++g) {
        mbar_expect_tx(&bars[g], k0 == kbeg ? S * 64 + R * 64 : S * 64);
        tma_load(es + g * (T::kCodeBox / 4), &te, &bars[g], g * kGroupDepth, k0);
        if (k0 == kbeg) tma_load(xs + g * (T::kRowBox / 4), &tx, &bars[g], g * kGroupDepth, row0);
      }
    }

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int g = 0; g < groups; ++g) {
      mbar_wait(&bars[g], parity);
      const float* eg = es + g * (T::kCodeBox / 4);
      const float* xg = xs + g * (T::kRowBox / 4);
      const int nq = min(4, quads - 4 * g);
      for (int ch = 0; ch < nq; ++ch) {
        // row tr + i RT swizzles as row tr, its quad index XOR 2 where
        // (RT / 2) i is 2 mod 4; code tc + j CT as code tc (CT is a multiple of 8)
        const int xo = xsw ^ (ch << 2);
        const float* eq = eg + (esw ^ (ch << 2));
        float4 xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int o = (xo ^ ((((T::kRowThreads / 2) * i) & 3) << 2)) +
                        i * T::kRowThreads * kGroupDepth;
          xv[i] = *reinterpret_cast<const float4*>(xg + o);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 ev =
              *reinterpret_cast<const float4*>(eq + j * T::kCodeThreads * kGroupDepth);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j] = fmaf(xv[i].x, ev.x, acc[i][j]);
            acc[i][j] = fmaf(xv[i].y, ev.y, acc[i][j]);
            acc[i][j] = fmaf(xv[i].z, ev.z, acc[i][j]);
            acc[i][j] = fmaf(xv[i].w, ev.w, acc[i][j]);
          }
        }
      }
    }
    for (int c = tid; c < S; c += kThreads) {  // ||e||^2, the same chain in depth order
      float s = 0.f;
      for (int q = 0; q < quads; ++q) {
        const float4 v = *quad(es + (q >> 2) * (T::kCodeBox / 4), c, q & 3);
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
      e2s[c] = s;
    }
    __syncthreads();                           // e2s is written
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tc + j * T::kCodeThreads;
      const bool in = c < nc;
      const float e2 = e2s[c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {           // -2 * dot is exact: -2 (x . e) + e2
        const float d = fmaf(-2.f, acc[i][j], e2);
        const bool lt = in && d < bd[i];
        bd[i] = lt ? d : bd[i];
        bk[i] = lt ? k0 + c : bk[i];
      }
    }
  }

  // the 8 code lanes of a row by shuffles; then each warp column's key of
  // row r goes to slot [rank][wc][r] of the CTA that owns r (r mod C) over
  // DSMEM, and after one cluster barrier the owner takes the least key
  unsigned long long best[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = pack_key(bd[i], bk[i]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      best[i] = umin(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
  }
  cluster_wait();
  if ((lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + i * T::kRowThreads;
      cl.map_shared_rank(slots, r % C)[(rank * WC + wc) * R + r] = best[i];
    }
  }
  cluster_arrive();
  cluster_wait();
  for (int r = rank + C * tid; r < R; r += C * kThreads) {
    unsigned long long m = ~0ull;
    for (int s = 0; s < C * WC; ++s) m = umin(m, slots[s * R + r]);
    if (row0 + r < a.N) a.idx[row0 + r] = static_cast<int64_t>(m & 0xffffffffull);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime already loaded.
EncodeTiledFn encode_tiled() {
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

// rows (rows, D) f32 read in boxes of 16 depth values x box_rows rows,
// 64-byte swizzle, zeros out of range
int encode_rows(CUtensorMap* map, const void* p, int rows, int D, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return kErrTensorMap + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {kGroupDepth, static_cast<cuuint32_t>(box_rows)}, estride[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

#define TRY(call)                                       \
  do {                                                  \
    cudaError_t e_ = (call);                            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <int TM, int TN, int WR, int WC>
int launch(const void* x, const void* emb, const Args& a, int cluster, int device,
           cudaStream_t st) {
  using T = Tile<TM, TN, WR, WC>;
  auto* kernel = search_kernel<TM, TN, WR, WC>;
  // the kernel's attributes, once per device: room for the widest rows, and
  // clusters past the portable 8
  static int configured[64] = {};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<T>(kMaxDim)));
    TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    configured[device] = 1;
  }
  CUtensorMap tx, te;
  int err = encode_rows(&tx, x, a.N, a.D, T::kRows);
  if (!err) err = encode_rows(&te, emb, a.K, a.D, T::kCodes);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((a.N + T::kRows - 1) / T::kRows * cluster);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>(a.D);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  TRY(cudaLaunchKernelEx(&cfg, kernel, tx, te, a));
  return static_cast<int>(cudaGetLastError());
}

// launch on `device`, the current device again afterwards
struct DeviceGuard {
  int prev = -1, dev;
  explicit DeviceGuard(int d) : dev(d) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != dev) cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != dev) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// idx (N,) int64 <- argmin_k fmaf(-2, x.e_k, ||e_k||^2) over x (N, D) and
// emb (K, D), f32, contiguous and 16-byte aligned on `device`, D a multiple
// of 4.  variant 0: 64-row tiles, 256 codes a CTA holds at once; 1: 8-row
// tiles, 128 codes.  cluster CTAs of `slice` codes each cover the codebook
// (none empty).  One launch on `stream`; returns its cudaError_t, 0 on
// success, without synchronising, or 10000 + the CUresult of a refused
// tensor map.  4 <= D <= 64, K < 2^31.
int talkshow_nearest_code(int N, int K, int D, int variant, int cluster, int slice,
                          const void* x, const void* emb, void* idx, int device,
                          void* stream) {
  if (N < 1 || K < 1 || D < 4 || D > kMaxDim || D % 4 || cluster < 1 ||
      cluster > kMaxCluster || slice < 1 || static_cast<long long>(cluster) * slice < K ||
      static_cast<long long>(cluster - 1) * slice >= K ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(emb)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<int64_t*>(idx), N, K, D, slice};
  const DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<8, 16, 2, 2>(x, emb, a, cluster, device, st);
    case 1: return launch<2, 2, 1, 8>(x, emb, a, cluster, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

// The wav2vec 2.0 raw-waveform conv feature extractor (K3), for Hopper.
//
// Replaces the TPU kernel talkshow_tpu/models/wav2vec_pallas.py:_run_extractor
// (:405, body _make_extractor_kernel :323-400), unmasked path: on a
// waveform (B, N) f32,
//   h0 = gelu(GroupNorm_per_channel(conv(wave, w0, k0, s0)))   1 -> C0
//   h  = gelu(conv(h, w_l, k_l, s_l))                          for each later layer
// VALID convs without bias; the GroupNorm statistics run over the whole
// time axis of each clip and channel.  The waveform and the weights are
// rounded to the table type (bf16 in production, f32 for exact comparison)
// and summed in f32; every layer's output is rounded to the table type, as
// the TPU kernel stores its intermediates (:373, :395); the last comes back
// as f32 (B, T_out, C).
//
// What bounds it on the card: at wav2vec 2.0 base on a 10 s clip (N 160 000,
// k10/s5 then k3 x4, k2 x2 at stride 2, 512 channels) the six strided convs
// are ~49 GFLOP per clip (~50 us at 989 TFLOP/s bf16), against ~9 MB of
// weights and ~1.7 MB of waveform and features in and out (~3 us at
// 3.35 TB/s): operation-bound.  The layer-0 conv is ~0.3 GFLOP.
//
// What the design does about it:
// - Activations are channels-last, so output frame t of a stride-s layer
//   reads the k * C_in contiguous values that start at frame s * t: each
//   strided conv is one GEMM (w2v_common.cuh: TMA + wgmma for bf16 tables,
//   f32 FMAs for f32) whose A rows overlap with stride s * C_in (a 3-D
//   tensor map {k C_in, T_out, B} with row stride s C_in), with gelu and the
//   rounding fused into its epilogue.  The TPU's polyphase even-first layout
//   (:258-321) exists only because Mosaic handles strided sublane access
//   badly; here the k = 2 layers need no zero third tap either.
// - GroupNorm needs each channel's mean and variance over the whole clip,
//   across blocks.  Layer 0 is cheap (k0 = 10 MACs per output), so it is
//   recomputed instead of stored in f32: a statistics pass, a finalising
//   pass and an apply pass.  A thread computes an 8-frame x 8-channel tile
//   of the conv from the shared waveform window and the transposed taps (a
//   broadcast sample and two 16-byte tap loads per 64 FMAs).  Statistics:
//   each tile's (mean, M2) by two passes over its registers, merged with
//   Chan's parallel-variance formula in a fixed order (tiles of a thread,
//   then the block's 4 thread groups: 128 frames a block), then across the
//   blocks by 8 warps per 32 channels and the 8 in order.  No float
//   atomics, so two runs agree bit for bit, and no E[x^2] - mean^2
//   cancellation over 32 000 frames (the TPU kernel's :364-365).  Apply:
//   32 frames a block, the tile normalised, gelu, rounded to the table type
//   and stored as one 16-byte row segment per frame.

#include "w2v_common.cuh"

using namespace w2v;

namespace {

constexpr int kStatFrames = 128;  // layer-0 frames per statistics block
constexpr int kApplyFrames = 32;  // ... per apply block
constexpr int kGroups = 4;        // thread groups of a block, each 1/4 of its frames
constexpr int kMaxK0 = 16;        // longest layer-0 kernel
constexpr int kConv0Threads = 256;
constexpr int kFinalWarps = 8;

struct Conv0 {
  int N, T0, k0, s0, C;
};

// Shared memory of a layer-0 block of nf frames: taps [k0][C], the window,
// and (statistics) the groups' (n, mean, M2) per channel.
size_t conv0_smem(const Conv0& c, int nf, bool stats) {
  return sizeof(float) * ((size_t)c.k0 * c.C + (size_t)(nf - 1) * c.s0 + c.k0 +
                          (stats ? (size_t)kGroups * c.C * 3 : 0));
}

// The taps, transposed to wt[j][ch], and the rounded waveform samples of
// frames [t0, t0 + nf) of clip b (zeros past the clip) into shared memory.
template <typename TW>
__device__ void load_conv0(const float* wave, const TW* w0, float* wt, float* win, int b, int t0,
                           int nf, const Conv0& c) {
  for (int i = threadIdx.x; i < c.k0 * c.C; i += blockDim.x)
    wt[i] = to_f(w0[(i % c.C) * c.k0 + i / c.C]);
  const float* src = wave + (size_t)b * c.N + (size_t)t0 * c.s0;
  const long long avail = (long long)c.N - (long long)t0 * c.s0;
  const int len = (nf - 1) * c.s0 + c.k0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) win[i] = i < avail ? round_to<TW>(src[i]) : 0.f;
}

// v[f][q] = the layer-0 conv at window frame f0 + f, channel ch0 + q: taps
// in order, f32 FMAs.
__device__ __forceinline__ void conv_tile(const float* win, const float* wt, int f0, int ch0,
                                          const Conv0& c, float (&v)[8][8]) {
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int q = 0; q < 8; ++q) v[f][q] = 0.f;
  for (int j = 0; j < c.k0; ++j) {
    const float4 wa = *reinterpret_cast<const float4*>(wt + j * c.C + ch0);
    const float4 wb = *reinterpret_cast<const float4*>(wt + j * c.C + ch0 + 4);
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float x = win[(f0 + f) * c.s0 + j];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[f][q] = fmaf(x, w[q], v[f][q]);
    }
  }
}

// (n, mean, M2) += (nb, mb, m2b), Chan's parallel-variance merge
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb <= 0.f) return;
  const float tot = n + nb, delta = mb - mean;
  mean += delta * (nb / tot);
  m2 += m2b + delta * delta * (n * nb / tot);
  n = tot;
}

// part (B, nblk, C, 2): each block's (mean, M2) per channel over its frames.
template <typename TW>
__global__ void __launch_bounds__(kConv0Threads)
conv0_stats_kernel(const float* wave, const TW* w0, float* part, Conv0 c) {
  extern __shared__ __align__(16) float sm0[];
  float* wt = sm0;
  float* win = wt + c.k0 * c.C;
  float* red = win + (kStatFrames - 1) * c.s0 + c.k0;   // [kGroups][C][3]
  const int blk = blockIdx.x, b = blockIdx.y, oct = c.C / 8;
  const int t0 = blk * kStatFrames, nt = min(kStatFrames, c.T0 - t0);
  load_conv0<TW>(wave, w0, wt, win, b, t0, kStatFrames, c);
  __syncthreads();
  constexpr int kTiles = kStatFrames / 8 / kGroups;   // 8-frame tiles per group
  for (int it = threadIdx.x; it < kGroups * oct; it += blockDim.x) {
    const int g = it / oct, ch0 = 8 * (it % oct);
    float n[8] = {}, mean[8] = {}, m2[8] = {};
    for (int i = 0; i < kTiles; ++i) {
      const int f0 = (g * kTiles + i) * 8, nf = min(8, nt - f0);
      if (nf <= 0) break;
      float v[8][8];
      conv_tile(win, wt, f0, ch0, c, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float sum = 0.f;
#pragma unroll
        for (int f = 0; f < 8; ++f) sum += f < nf ? v[f][q] : 0.f;
        const float mb = sum / nf;
        float m2b = 0.f;
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float d = v[f][q] - mb;
          m2b = f < nf ? fmaf(d, d, m2b) : m2b;
        }
        chan_merge(n[q], mean[q], m2[q], (float)nf, mb, m2b);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float* r = red + ((size_t)g * c.C + ch0 + q) * 3;
      r[0] = n[q];
      r[1] = mean[q];
      r[2] = m2[q];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c.C; ch += blockDim.x) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      const float* r = red + ((size_t)g * c.C + ch) * 3;
      chan_merge(n, mean, m2, r[0], r[1], r[2]);
    }
    float* p = part + (((size_t)b * gridDim.x + blk) * c.C + ch) * 2;
    p[0] = mean;
    p[1] = m2;
  }
}

// stats (B, C, 2): mean and 1/sqrt(var + eps).  Warp w merges blocks
// [w nblk / 8, (w + 1) nblk / 8) for its lane's channel, then warp 0 merges
// the 8 in order.
__global__ void __launch_bounds__(kFinalWarps * 32)
gn_finalize_kernel(const float* part, float* stats, int nblk, Conv0 c, float eps) {
  __shared__ float red[kFinalWarps][32][3];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, b = blockIdx.y;
  const int ch = blockIdx.x * 32 + lane;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < c.C) {
    const int k1 = (warp + 1) * nblk / kFinalWarps;
    for (int k = warp * nblk / kFinalWarps; k < k1; ++k) {
      const float2 p = *reinterpret_cast<const float2*>(part + (((size_t)b * nblk + k) * c.C + ch) * 2);
      chan_merge(n, mean, m2, (float)min(kStatFrames, c.T0 - k * kStatFrames), p.x, p.y);
    }
  }
  red[warp][lane][0] = n;
  red[warp][lane][1] = mean;
  red[warp][lane][2] = m2;
  __syncthreads();
  if (warp != 0 || ch >= c.C) return;
  for (int w = 1; w < kFinalWarps; ++w) chan_merge(n, mean, m2, red[w][lane][0], red[w][lane][1], red[w][lane][2]);
  stats[((size_t)b * c.C + ch) * 2] = mean;
  stats[((size_t)b * c.C + ch) * 2 + 1] = rsqrtf(m2 / n + eps);
}

template <typename TW> __device__ __forceinline__ void store8(TW* p, const float (&o)[8]);
template <> __device__ __forceinline__ void store8<float>(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
template <> __device__ __forceinline__ void store8<bf16>(bf16* p, const float (&o)[8]) {
  const auto pack = [](float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  };
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]), pack(o[6], o[7]));
}

// h0 (B, T0, C) of TW = gelu((conv - mean) * rstd * scale + bias), rounded.
template <typename TW>
__global__ void __launch_bounds__(kConv0Threads)
conv0_apply_kernel(const float* wave, const TW* w0, const float* stats, const float* gn,
                   TW* h0, Conv0 c) {
  extern __shared__ __align__(16) float sm0[];
  float* wt = sm0;
  float* win = wt + c.k0 * c.C;
  const int blk = blockIdx.x, b = blockIdx.y, oct = c.C / 8;
  const int t0 = blk * kApplyFrames, nt = min(kApplyFrames, c.T0 - t0);
  load_conv0<TW>(wave, w0, wt, win, b, t0, kApplyFrames, c);
  __syncthreads();
  for (int it = threadIdx.x; it < kGroups * oct; it += blockDim.x) {
    const int f0 = (it / oct) * 8, ch0 = 8 * (it % oct);
    if (f0 >= nt) continue;
    float v[8][8];
    conv_tile(win, wt, f0, ch0, c, v);
    float mean[8], rstd[8], mul[8], add[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 st = *reinterpret_cast<const float2*>(stats + ((size_t)b * c.C + ch0 + q) * 2);
      mean[q] = st.x;
      rstd[q] = st.y;
      mul[q] = gn[ch0 + q];
      add[q] = gn[c.C + ch0 + q];
    }
    TW* dst = h0 + ((size_t)b * c.T0 + t0 + f0) * c.C + ch0;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      if (f0 + f >= nt) break;
      float o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) o[q] = gelu((v[f][q] - mean[q]) * rstd[q] * mul[q] + add[q]);
      store8<TW>(dst + (size_t)f * c.C, o);
    }
  }
}

struct Plan {   // frame counts and scratch layout for one call
  int n_layers, T[16], k[16], s[16], C[16], nblk;
  size_t part, stats, buf[2], total;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

bool make_plan(int dtype, int B, int N, int n_layers, const int* dims, Plan* p) {
  if (n_layers < 2 || n_layers > 16 || (dtype != 0 && dtype != 1)) return false;
  p->n_layers = n_layers;
  int n = N;
  for (int l = 0; l < n_layers; ++l) {
    p->k[l] = dims[3 * l];
    p->s[l] = dims[3 * l + 1];
    p->C[l] = dims[3 * l + 2];
    if (p->k[l] < 1 || p->s[l] < 1 || p->C[l] < 1) return false;
    n = (n - p->k[l]) / p->s[l] + 1;
    p->T[l] = n;
    if (n < 1) return false;
  }
  if (p->k[0] > kMaxK0) return false;
  const size_t es = dtype == 1 ? 2 : 4;
  p->nblk = (p->T[0] + kStatFrames - 1) / kStatFrames;
  p->part = 0;
  p->stats = align256((size_t)B * p->nblk * p->C[0] * 2 * sizeof(float));
  size_t buf[2] = {0, 0};           // layer l's output lives in buf[l % 2]; the last in `out`
  for (int l = 0; l + 1 < n_layers; ++l) {
    const size_t bytes = align256((size_t)B * p->T[l] * p->C[l] * es);
    if (bytes > buf[l % 2]) buf[l % 2] = bytes;
  }
  p->buf[0] = p->stats + align256((size_t)B * p->C[0] * 2 * sizeof(float));
  p->buf[1] = p->buf[0] + buf[0];
  p->total = p->buf[1] + buf[1];
  return true;
}

template <typename TW>
int run(const Plan& p, int B, int N, float eps, const TW* w0, const TW* ws, const float* gn,
        const float* wave, float* out, char* scratch, cudaStream_t st) {
  float* part = reinterpret_cast<float*>(scratch + p.part);
  float* stats = reinterpret_cast<float*>(scratch + p.stats);
  TW* buf[2] = {reinterpret_cast<TW*>(scratch + p.buf[0]),
                reinterpret_cast<TW*>(scratch + p.buf[1])};
  const Conv0 c{N, p.T[0], p.k[0], p.s[0], p.C[0]};
  const size_t sm_stats = conv0_smem(c, kStatFrames, true), sm_apply = conv0_smem(c, kApplyFrames, false);
  if (sm_stats > 232448) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(conv0_stats_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm_stats)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(conv0_apply_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sm_apply)) != cudaSuccess)
    return e;
  conv0_stats_kernel<TW><<<dim3(p.nblk, B), kConv0Threads, sm_stats, st>>>(wave, w0, part, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_finalize_kernel<<<dim3((c.C + 31) / 32, B), kFinalWarps * 32, 0, st>>>(part, stats, p.nblk, c,
                                                                          eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv0_apply_kernel<TW><<<dim3((c.T0 + kApplyFrames - 1) / kApplyFrames, B), kConv0Threads,
                           sm_apply, st>>>(wave, w0, stats, gn, buf[0], c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const TW* w = ws;
  for (int l = 1; l < p.n_layers; ++l) {
    const int cin = p.C[l - 1], tin = p.T[l - 1], K = p.k[l] * cin;
    const long long lda = (long long)p.s[l] * cin, a_batch = (long long)tin * cin;
    const bool last = l + 1 == p.n_layers;
    Epi ep{};
    ep.gelu = 1; ep.ldc = p.C[l]; ep.c_batch = (long long)p.T[l] * p.C[l];
    ep.c = last ? static_cast<void*>(out) : static_cast<void*>(buf[l % 2]);
    int r;
    if constexpr (sizeof(TW) == 2) {
      ep.round_bf16 = last;
      r = last ? gemm_bf16<float>(buf[(l - 1) % 2], lda, a_batch, w, p.T[l], p.C[l], K, B, ep, st)
               : gemm_bf16<bf16>(buf[(l - 1) % 2], lda, a_batch, w, p.T[l], p.C[l], K, B, ep, st);
    } else {
      r = gemm_f32(FmaArgs{buf[(l - 1) % 2], lda, a_batch, w, p.T[l], p.C[l], K}, ep, B, st);
    }
    if (r != 0) return r;
    w += (size_t)p.C[l] * K;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of scratch that talkshow_w2v_extractor needs (-1 for a bad shape).
// dims: (kernel, stride, channels out) per layer, host memory.
long long talkshow_w2v_extractor_scratch(int table_dtype, int B, int N, int n_layers,
                                         const int* dims) {
  Plan p;
  return make_plan(table_dtype, B, N, n_layers, dims, &p) ? (long long)p.total : -1;
}

// Run the conv stack on wave (B, N) f32 into out (B, T_out, C_last) f32 on
// `stream`.  table_dtype: 0 f32, 1 bf16 tables.  w0 (C0, k0) and ws (every
// later layer's (C_out, k * C_in), tap-major rows, concatenated) of the table
// type; gn (2, C0) f32.  Returns the first CUDA error (0 on success;
// kErrTensorMap + a CUresult when a tensor map is refused); nothing here
// synchronises.
int talkshow_w2v_extractor(int table_dtype, int B, int N, int n_layers, const int* dims,
                           float eps, const void* w0, const void* ws, const float* gn,
                           const float* wave, float* out, void* scratch, void* stream) {
  Plan p;
  if (B < 1 || !make_plan(table_dtype, B, N, n_layers, dims, &p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(scratch);
  if (table_dtype == 0)
    return run<float>(p, B, N, eps, static_cast<const float*>(w0),
                      static_cast<const float*>(ws), gn, wave, out, s, st);
  return run<bf16>(p, B, N, eps, static_cast<const bf16*>(w0), static_cast<const bf16*>(ws),
                   gn, wave, out, s, st);
}

}  // extern "C"

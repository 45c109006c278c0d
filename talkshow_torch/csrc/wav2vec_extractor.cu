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
// What the design does about it, for now (a right, simple kernel first):
// - Activations are channels-last, so output frame t of a stride-s layer
//   reads the k * C_in contiguous values that start at frame s * t: each
//   strided conv is one GEMM (w2v_common.cuh, bf16 tensor-core mma.sync or
//   f32 FMAs) whose A rows overlap with stride s * C_in, with gelu and the
//   rounding fused into its epilogue.  The TPU's polyphase even-first layout
//   (:258-321) exists only because Mosaic handles strided sublane access
//   badly; here the k = 2 layers need no zero third tap either.
// - GroupNorm needs each channel's mean and variance over the whole clip,
//   across blocks.  Layer 0 is cheap (k0 = 10 MACs per output), so it is
//   recomputed instead of stored in f32: a statistics pass where each block
//   takes 256 frames and writes its (mean, M2) per channel (two passes over
//   its frames), a finalising pass that merges the blocks in a fixed order
//   (Chan's parallel-variance formula; no float atomics, so two runs agree
//   bit for bit), and an apply pass that recomputes the conv, normalises,
//   applies gelu and stores h0 in the table type.  Two-pass statistics
//   avoid the cancellation of E[x^2] - mean^2 (the TPU kernel's :364-365)
//   over 32 000 frames.
// wgmma/TMA, a multi-stage load ring and keeping a clip's activations on
// chip between layers are later work.

#include <initializer_list>

#include "w2v_common.cuh"

using namespace w2v;

namespace {

constexpr int kFrames = 256;      // layer-0 frames per statistics / apply block
constexpr int kMaxK0 = 16;        // layer-0 taps held in registers
constexpr int kConv0Threads = 256;

struct Conv0 {
  int N, T0, k0, s0, C;
};

// Rounded waveform samples of frames [t0, t0 + nt) of clip b into shared memory.
template <typename TW>
__device__ void load_window(const float* wave, float* win, int b, int t0, int nt,
                            const Conv0& c) {
  const float* src = wave + (size_t)b * c.N + (size_t)t0 * c.s0;
  const int len = (nt - 1) * c.s0 + c.k0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) win[i] = round_to<TW>(src[i]);
}

template <typename TW>
__device__ __forceinline__ void load_taps(const TW* w0, int ch, const Conv0& c,
                                          float w[kMaxK0]) {
#pragma unroll
  for (int j = 0; j < kMaxK0; ++j) w[j] = j < c.k0 ? to_f(w0[ch * c.k0 + j]) : 0.f;
}

__device__ __forceinline__ float conv_at(const float* win, int t, const float w[kMaxK0],
                                         const Conv0& c) {
  const float* x = win + t * c.s0;
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK0; ++j)
    if (j < c.k0) v = fmaf(x[j], w[j], v);
  return v;
}

// part (B, nblk, C, 2): each block's (mean, sum of squared deviations).
template <typename TW>
__global__ void __launch_bounds__(kConv0Threads)
conv0_stats_kernel(const float* wave, const TW* w0, float* part, Conv0 c) {
  extern __shared__ float win[];
  const int blk = blockIdx.x, b = blockIdx.y;
  const int t0 = blk * kFrames, nt = min(kFrames, c.T0 - t0);
  load_window<TW>(wave, win, b, t0, nt, c);
  __syncthreads();
  for (int ch = threadIdx.x; ch < c.C; ch += blockDim.x) {
    float w[kMaxK0];
    load_taps(w0, ch, c, w);
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += conv_at(win, t, w, c);
    const float mean = s / nt;
    float m2 = 0.f;
    for (int t = 0; t < nt; ++t) {
      const float d = conv_at(win, t, w, c) - mean;
      m2 = fmaf(d, d, m2);
    }
    float* p = part + (((size_t)b * gridDim.x + blk) * c.C + ch) * 2;
    p[0] = mean;
    p[1] = m2;
  }
}

// stats (B, C, 2): mean and 1/sqrt(var + eps), merging the blocks in order.
__global__ void gn_finalize_kernel(const float* part, float* stats, int nblk, Conv0 c,
                                   float eps) {
  const int b = blockIdx.y, ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c.C) return;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = 0; k < nblk; ++k) {
    const float* p = part + (((size_t)b * nblk + k) * c.C + ch) * 2;
    const float nb = (float)min(kFrames, c.T0 - k * kFrames);
    const float tot = n + nb, delta = p[0] - mean;
    mean += delta * (nb / tot);
    m2 += p[1] + delta * delta * (n * nb / tot);
    n = tot;
  }
  stats[((size_t)b * c.C + ch) * 2] = mean;
  stats[((size_t)b * c.C + ch) * 2 + 1] = rsqrtf(m2 / n + eps);
}

// h0 (B, T0, C) of TW = gelu((conv - mean) * rstd * scale + bias), rounded.
template <typename TW>
__global__ void __launch_bounds__(kConv0Threads)
conv0_apply_kernel(const float* wave, const TW* w0, const float* stats, const float* gn,
                   TW* h0, Conv0 c) {
  extern __shared__ float win[];
  const int blk = blockIdx.x, b = blockIdx.y;
  const int t0 = blk * kFrames, nt = min(kFrames, c.T0 - t0);
  load_window<TW>(wave, win, b, t0, nt, c);
  __syncthreads();
  for (int ch = threadIdx.x; ch < c.C; ch += blockDim.x) {
    float w[kMaxK0];
    load_taps(w0, ch, c, w);
    const float mean = stats[((size_t)b * c.C + ch) * 2];
    const float rstd = stats[((size_t)b * c.C + ch) * 2 + 1];
    const float scale = gn[ch], bias = gn[c.C + ch];
    TW* dst = h0 + ((size_t)b * c.T0 + t0) * c.C + ch;
    for (int t = 0; t < nt; ++t) {
      const float v = (conv_at(win, t, w, c) - mean) * rstd * scale + bias;
      dst[(size_t)t * c.C] = from_f<TW>(gelu(v));
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
  p->nblk = (p->T[0] + kFrames - 1) / kFrames;
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
cudaError_t run(const Plan& p, int B, int N, float eps, const TW* w0, const TW* ws,
                const float* gn, const float* wave, float* out, char* scratch,
                cudaStream_t st) {
  float* part = reinterpret_cast<float*>(scratch + p.part);
  float* stats = reinterpret_cast<float*>(scratch + p.stats);
  TW* buf[2] = {reinterpret_cast<TW*>(scratch + p.buf[0]),
                reinterpret_cast<TW*>(scratch + p.buf[1])};
  const Conv0 c{N, p.T[0], p.k[0], p.s[0], p.C[0]};
  const dim3 grid0(p.nblk, B);
  const size_t win = sizeof(float) * ((size_t)(kFrames - 1) * c.s0 + c.k0);
  if (win > 232448) return cudaErrorInvalidValue;
  cudaError_t e;
  for (const void* fn : {(const void*)conv0_stats_kernel<TW>, (const void*)conv0_apply_kernel<TW>})
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)win)) !=
        cudaSuccess)
      return e;
  conv0_stats_kernel<TW><<<grid0, kConv0Threads, win, st>>>(wave, w0, part, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_finalize_kernel<<<dim3((c.C + 127) / 128, B), 128, 0, st>>>(part, stats, p.nblk, c, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv0_apply_kernel<TW><<<grid0, kConv0Threads, win, st>>>(wave, w0, stats, gn, buf[0], c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const TW* w = ws;
  for (int l = 1; l < p.n_layers; ++l) {
    const int cin = p.C[l - 1], tin = p.T[l - 1];
    GemmArgs g{};
    g.a = buf[(l - 1) % 2]; g.lda = (long long)p.s[l] * cin; g.a_batch = (long long)tin * cin;
    g.w = w; g.ldc = p.C[l]; g.c_batch = (long long)p.T[l] * p.C[l];
    g.M = p.T[l]; g.N = p.C[l]; g.K = p.k[l] * cin; g.gelu = 1;
    if (l + 1 < p.n_layers) {
      g.c = buf[l % 2];
      e = gemm<TW, TW, TW>(g, B, st);
    } else {
      g.c = out;
      g.round_bf16 = sizeof(TW) == 2;
      e = gemm<TW, TW, float>(g, B, st);
    }
    if (e != cudaSuccess) return e;
    w += (size_t)p.C[l] * g.K;
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
// type; gn (2, C0) f32.  Returns the first CUDA error (0 on success); nothing
// here synchronises.
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

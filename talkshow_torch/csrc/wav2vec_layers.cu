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
// What the design does about it, for now (a right, simple kernel first):
// - The layer is the TPU kernel's function, not its block structure: 7
//   launches per layer, all from one host call per stack, nothing
//   synchronised: the four products are one tiled GEMM (w2v_common.cuh:
//   bf16 tensor-core mma.sync with f32 accumulators, or f32 FMAs) whose
//   epilogue fuses bias, gelu and the residual; LayerNorm needs whole
//   768-wide rows, so it is a second, row-wise pass (one warp per row,
//   two-pass mean and variance).
// - Tiles are read with 16-byte loads staged in registers, all of a
//   thread's share in flight before the first store.
// - Attention: one block per (query tile of 16, head, batch).  T is a few
//   hundred frames, so the block keeps its whole (16, T) score tile in
//   shared memory and computes the softmax exactly in two passes (max, then
//   normalised exp) instead of online: the probabilities are rounded to the
//   table type at the same point as in the plain version.  Rows at or past
//   valid_frames still attend to the valid keys, so they stay finite.
// - Weights are packed output-major (nn.Linear's layout; no transposed copy
//   of the TPU's (in, out) tables), so GEMM tiles load K-contiguous.
// wgmma/TMA, a multi-stage cp.async ring and LayerNorm fused into the GEMM
// (one block owning full rows) are later work.

#include "w2v_common.cuh"

using namespace w2v;

namespace {

constexpr int kTQ = 16;           // query rows per attention block
constexpr int kTK = 64;           // keys per staged K or V tile
constexpr int kAttnThreads = 128;
constexpr int kMaxHd = 128;
constexpr int kDimGroups = kMaxHd / 16;   // head dims per thread in the P.V pass
constexpr int kKvLoads = kTK * kMaxHd / 4 / kAttnThreads;   // float4 loads per thread
constexpr int kLnRows = 8;        // rows (warps) per LayerNorm block

// Rows [k0, k0 + nk) of one head's K or V (column offset `off` of qkv rows)
// into KV[kTK][hd + 1], rounded to TW; rows past nk are zero.  Every load of
// the tile is in flight before the first store, so their latencies overlap.
template <typename TW>
__device__ __forceinline__ void load_kv_tile(const float* base, int ld, int off, int k0,
                                             int nk, int hd, float* KV) {
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
      dst[0] = round_to<TW>(r[j].x);
      dst[1] = round_to<TW>(r[j].y);
      dst[2] = round_to<TW>(r[j].z);
      dst[3] = round_to<TW>(r[j].w);
    }
  }
}

size_t attn_smem(int T, int hd) {
  return sizeof(float) * ((size_t)kTQ * T + (size_t)(kTQ + kTK) * (hd + 1));
}

// qkv (B, T, 3H) f32 = [q | k | v], head h at columns h*hd.  ctx (B, T, H).
template <typename TW>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* qkv, const int* valid, float* ctx, int T, int H, int hd,
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
    Q[r * kvld + d] =
        r < nq ? round_to<TW>(base[(size_t)(q0 + r) * ld + h * hd + d] * scale) : 0.f;
  }
  for (int k0 = 0; k0 < T; k0 += kTK) {
    const int nk = min(kTK, T - k0);
    __syncthreads();
    load_kv_tile<TW>(base, ld, H + h * hd, k0, nk, hd, KV);
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
    for (int c = lane; c < T; c += 32) row[c] = round_to<TW>(row[c] / sum);
  }

  float o[2][kDimGroups] = {};
  for (int k0 = 0; k0 < T; k0 += kTK) {
    const int nk = min(kTK, T - k0);
    __syncthreads();
    load_kv_tile<TW>(base, ld, 2 * H + h * hd, k0, nk, hd, KV);
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

// y = LayerNorm(x) * gb[0:H] + gb[H:2H] over rows of width H; one warp per row.
__global__ void __launch_bounds__(kLnRows * 32)
layernorm_kernel(const float* x, const float* gb, float* y, int M, int H, float eps) {
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += xr[c];
  const float mean = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = xr[c] - mean;
    v = fmaf(d, d, v);
  }
  const float rstd = rsqrtf(warp_sum(v) / H + eps);
  float* yr = y + (size_t)row * H;
  for (int c = lane; c < H; c += 32) yr[c] = (xr[c] - mean) * rstd * gb[c] + gb[H + c];
}

struct Dims {
  int B, T, H, heads, F, L;
  float eps;
};

struct Tables {
  const void *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *b1, *b2, *ln1, *ln2;
};

cudaError_t layernorm(const float* x, const float* gb, float* y, int M, int H, float eps,
                      cudaStream_t st) {
  layernorm_kernel<<<(M + kLnRows - 1) / kLnRows, kLnRows * 32, 0, st>>>(x, gb, y, M, H, eps);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t run(const Dims& d, const Tables& t, const int* valid, const float* x, float* out,
                float* scratch, cudaStream_t st) {
  const int B = d.B, T = d.T, H = d.H, F = d.F, hd = H / d.heads, M = B * T;
  float* qkv = scratch;
  float* ctx = qkv + (size_t)M * 3 * H;
  float* y = ctx + (size_t)M * H;
  float* xn = y + (size_t)M * H;
  float* hb = xn + (size_t)M * H;
  const size_t smem = attn_smem(T, hd);
  if (hd > kMaxHd || hd % 4 || H % 8 || F % 8 || smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<TW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 attn_grid((T + kTQ - 1) / kTQ, d.heads, B);
  const float scale = 1.0f / sqrtf((float)hd);
  const float* cur = x;
  for (int l = 0; l < d.L; ++l) {
    const TW* wqkv = static_cast<const TW*>(t.wqkv) + (size_t)l * 3 * H * H;
    const TW* wo = static_cast<const TW*>(t.wo) + (size_t)l * H * H;
    const TW* w1 = static_cast<const TW*>(t.w1) + (size_t)l * F * H;
    const TW* w2 = static_cast<const TW*>(t.w2) + (size_t)l * H * F;

    GemmArgs g{};
    g.a = cur; g.lda = H; g.w = wqkv; g.bias = t.bqkv + (size_t)l * 3 * H;
    g.c = qkv; g.ldc = 3 * H; g.M = M; g.N = 3 * H; g.K = H;
    if ((e = gemm<float, TW, float>(g, 1, st)) != cudaSuccess) return e;

    attention_kernel<TW><<<attn_grid, kAttnThreads, smem, st>>>(qkv, valid, ctx, T, H, hd, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    g = GemmArgs{};
    g.a = ctx; g.lda = H; g.w = wo; g.bias = t.bo + (size_t)l * H;
    g.resid = cur; g.ldr = H; g.c = y; g.ldc = H; g.M = M; g.N = H; g.K = H;
    if ((e = gemm<float, TW, float>(g, 1, st)) != cudaSuccess) return e;
    if ((e = layernorm(y, t.ln1 + (size_t)l * 2 * H, xn, M, H, d.eps, st)) != cudaSuccess)
      return e;

    g = GemmArgs{};
    g.a = xn; g.lda = H; g.w = w1; g.bias = t.b1 + (size_t)l * F; g.gelu = 1;
    g.c = hb; g.ldc = F; g.M = M; g.N = F; g.K = H;
    if ((e = gemm<float, TW, float>(g, 1, st)) != cudaSuccess) return e;

    g = GemmArgs{};
    g.a = hb; g.lda = F; g.w = w2; g.bias = t.b2 + (size_t)l * H;
    g.resid = xn; g.ldr = H; g.c = y; g.ldc = H; g.M = M; g.N = H; g.K = F;
    if ((e = gemm<float, TW, float>(g, 1, st)) != cudaSuccess) return e;
    if ((e = layernorm(y, t.ln2 + (size_t)l * 2 * H, out, M, H, d.eps, st)) != cudaSuccess)
      return e;
    cur = out;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of scratch that talkshow_w2v_layers needs: qkv, ctx, two (B*T, H)
// row buffers and the FFN hidden layer.
long long talkshow_w2v_layers_scratch(int B, int T, int H, int F) {
  return (long long)B * T * (6LL * H + F);
}

// Run the L-layer stack on x (B, T, H) f32 into out (B, T, H) on `stream`.
// table_dtype: 0 f32 tables, 1 bf16 tables.  Matrices (L, out, in) of the
// table type; bqkv (L, 3H), bo (L, H), b1 (L, F), b2 (L, H), ln1/ln2
// (L, 2, H) f32; valid (B,) int32 on the device.  x and out may not alias.
// Returns the first CUDA error (0 on success); nothing here synchronises.
int talkshow_w2v_layers(int table_dtype, int B, int T, int H, int heads, int F, int L,
                        float eps, const void* wqkv, const void* wo, const void* w1,
                        const void* w2, const float* bqkv, const float* bo, const float* b1,
                        const float* b2, const float* ln1, const float* ln2, const int* valid,
                        const float* x, float* out, float* scratch, void* stream) {
  const Dims d{B, T, H, heads, F, L, eps};
  const Tables t{wqkv, wo, w1, w2, bqkv, bo, b1, b2, ln1, ln2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || heads < 1 || H % heads) return cudaErrorInvalidValue;
  if (table_dtype == 0) return run<float>(d, t, valid, x, out, scratch, st);
  if (table_dtype == 1) return run<bf16>(d, t, valid, x, out, scratch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

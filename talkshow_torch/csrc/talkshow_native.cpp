// talkshow_native: threaded host-side audio preprocessing + rendering.
//
// The TPU compute path is JAX/XLA/Pallas; this library accelerates the
// host-bound stages:
//   * per-clip audio featurization during dataset preprocessing (the
//     reference precomputes MFCCs clip-by-clip in python,
//     data_utils/mesh_dataset.py:204-220, which dominates first-run load
//     time), and
//   * SMPL-X mesh rasterization for visualisation (the reference uses
//     pyrender/OpenGL, visualise/rendering.py + voca/rendering.py; this is
//     a dependency-free software rasterizer with the same orthographic
//     camera and a lambert approximation of its light rig).
//
// Exposes, via a C ABI (ctypes):
//   * ts_resample_sinc : polyphase windowed-sinc resampling, identical
//     algorithm to talkshow_tpu.ops.audio.resample (torchaudio
//     sinc_interp_hann semantics)
//   * ts_mfcc          : frame (reflect-pad, hann) -> FFT -> power ->
//     mel (matrix passed in) -> dB (top_db) -> DCT (matrix passed in)
//   * ts_mfcc_batch    : OpenMP-parallel MFCC over many clips
//   * ts_rasterize     : z-buffered barycentric triangle rasterization with
//     smooth (vertex-normal) lambert shading, two-sided (the reference
//     renders with SKIP_CULL_FACES)
//
// Mel/DCT matrices are supplied by the caller so numerics match the JAX
// frontend bit-for-bit in construction.
//
// Build: make -C native   (g++ -O3 -fopenmp -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Iterative radix-2 complex FFT (n must be a power of two).
// ---------------------------------------------------------------------------
void fft_radix2(std::vector<double>& re, std::vector<double>& im) {
  const size_t n = re.size();
  // bit reversal
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        const double ur = re[i + k], ui = im[i + k];
        const double vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        const double vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

// one frame -> power spectrum (n_fft/2+1 bins)
void frame_power(const float* frame, const float* window, int n_fft,
                 double* power_out) {
  std::vector<double> re(n_fft), im(n_fft, 0.0);
  for (int i = 0; i < n_fft; ++i)
    re[i] = static_cast<double>(frame[i]) * static_cast<double>(window[i]);
  fft_radix2(re, im);
  const int bins = n_fft / 2 + 1;
  for (int i = 0; i < bins; ++i) power_out[i] = re[i] * re[i] + im[i] * im[i];
}

// reflect-padded sample access
inline float reflect_at(const float* x, int64_t n, int64_t i) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return x[i];
}

}  // namespace

extern "C" {

// Polyphase windowed-sinc resampling; matches ops/audio.resample.
// Returns number of output samples written (<= out_cap).
int64_t ts_resample_sinc(const float* x, int64_t n, int32_t orig_freq,
                         int32_t new_freq, int32_t lowpass_filter_width,
                         float rolloff, float* out, int64_t out_cap) {
  auto gcd = [](int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
  };
  const int64_t g = gcd(orig_freq, new_freq);
  const int64_t orig = orig_freq / g, newf = new_freq / g;
  const double base_freq = static_cast<double>(std::min(orig, newf)) * rolloff;
  const int64_t width =
      static_cast<int64_t>(std::ceil(lowpass_filter_width * orig / base_freq));
  const int64_t klen = 2 * width + orig;

  // kernel[p][k] for phase p in [0, newf)
  std::vector<double> kernel(static_cast<size_t>(newf * klen));
  for (int64_t p = 0; p < newf; ++p) {
    for (int64_t k = 0; k < klen; ++k) {
      double t = (-static_cast<double>(p) / newf) +
                 static_cast<double>(k - width) / orig;
      t *= base_freq;
      if (t < -lowpass_filter_width) t = -lowpass_filter_width;
      if (t > lowpass_filter_width) t = lowpass_filter_width;
      const double win =
          std::pow(std::cos(t * kPi / lowpass_filter_width / 2.0), 2.0);
      const double tp = t * kPi;
      const double sinc = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      kernel[static_cast<size_t>(p * klen + k)] =
          sinc * win * (base_freq / orig);
    }
  }

  const int64_t target_len =
      static_cast<int64_t>(std::ceil(static_cast<double>(newf) * n / orig));
  const int64_t blocks = (n + orig - 1) / orig + 1;
  int64_t written = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < blocks; ++b) {
    for (int64_t p = 0; p < newf; ++p) {
      const int64_t oi = b * newf + p;
      if (oi >= target_len || oi >= out_cap) continue;
      double acc = 0.0;
      const int64_t x0 = b * orig - width;
      for (int64_t k = 0; k < klen; ++k) {
        const int64_t xi = x0 + k;
        if (xi >= 0 && xi < n)
          acc += kernel[static_cast<size_t>(p * klen + k)] * x[xi];
      }
      out[oi] = static_cast<float>(acc);
    }
  }
  written = std::min(target_len, out_cap);
  return written;
}

// MFCC of one waveform.
//   x[n], hann window[n_fft], mel_fb[(n_fft/2+1) * n_mels] row-major,
//   dct[n_mels * n_mfcc] row-major, top_db (<=0 disables).
// out[num_frames * n_mfcc]; returns num_frames.
int64_t ts_mfcc(const float* x, int64_t n, int32_t n_fft, int32_t hop,
                const float* window, const float* mel_fb, int32_t n_mels,
                const float* dct, int32_t n_mfcc, float top_db, float* out,
                int64_t out_cap_frames) {
  const int64_t pad = n_fft / 2;
  const int64_t padded = n + 2 * pad;
  const int64_t num_frames = 1 + (padded - n_fft) / hop;
  const int bins = n_fft / 2 + 1;
  if (num_frames > out_cap_frames) return -1;

  std::vector<float> mel_db(static_cast<size_t>(num_frames * n_mels));
  float global_max = -1e30f;

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> frame(n_fft);
    std::vector<double> power(bins);
    float local_max = -1e30f;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t f = 0; f < num_frames; ++f) {
      const int64_t start = f * hop - pad;
      for (int i = 0; i < n_fft; ++i)
        frame[i] = reflect_at(x, n, start + i);
      frame_power(frame.data(), window, n_fft, power.data());
      for (int m = 0; m < n_mels; ++m) {
        double acc = 0.0;
        for (int b = 0; b < bins; ++b)
          acc += power[b] * mel_fb[static_cast<size_t>(b) * n_mels + m];
        float db = 10.0f * std::log10(std::max(acc, 1e-10));
        mel_db[static_cast<size_t>(f) * n_mels + m] = db;
        local_max = std::max(local_max, db);
      }
    }
#ifdef _OPENMP
#pragma omp critical
#endif
    global_max = std::max(global_max, local_max);
  }

  const float floor_db = (top_db > 0) ? global_max - top_db : -1e30f;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t f = 0; f < num_frames; ++f) {
    for (int c = 0; c < n_mfcc; ++c) {
      double acc = 0.0;
      for (int m = 0; m < n_mels; ++m) {
        const float v =
            std::max(mel_db[static_cast<size_t>(f) * n_mels + m], floor_db);
        acc += static_cast<double>(v) * dct[static_cast<size_t>(m) * n_mfcc + c];
      }
      out[f * n_mfcc + c] = static_cast<float>(acc);
    }
  }
  return num_frames;
}

int32_t ts_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// Software mesh rasterizer (visualisation; mirrors the reference pyrender
// setup: orthographic camera at (0, cam_y, cam_z) looking down -Z with
// half-extents (xmag, ymag), smooth vertex-normal shading, two-sided).
//
// verts      : (V, 3) float32, world space (caller applies the y/z flip)
// faces      : (F, 3) int32
// lights     : (n_lights, 4) float32 rows [px, py, pz, intensity] — point
//              lights with 1/d^2 falloff (matching pyrender's attenuation)
// base_color : (3,) float32 in [0, 1]
// out_rgb    : (height, width, 3) uint8, preallocated; fully overwritten
//              (background white, like the reference bg_color)
// Returns 0 on success.
// ---------------------------------------------------------------------------
int32_t ts_rasterize(const float* verts, int64_t V, const int32_t* faces,
                     int64_t F, float xmag, float ymag, float cam_y,
                     float cam_z, const float* lights, int32_t n_lights,
                     float ambient, const float* base_color, int32_t width,
                     int32_t height, uint8_t* out_rgb) {
  if (V <= 0 || F <= 0 || width <= 0 || height <= 0) return -1;

  // ---- vertex normals (area-weighted face-normal accumulation) ----------
  std::vector<float> vnorm(static_cast<size_t>(V) * 3, 0.0f);
  for (int64_t f = 0; f < F; ++f) {
    const int32_t a = faces[f * 3], b = faces[f * 3 + 1], c = faces[f * 3 + 2];
    if (a < 0 || b < 0 || c < 0 || a >= V || b >= V || c >= V) return -2;
    const float* pa = verts + a * 3;
    const float* pb = verts + b * 3;
    const float* pc = verts + c * 3;
    const float e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    const float e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    const float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                        e1[2] * e2[0] - e1[0] * e2[2],
                        e1[0] * e2[1] - e1[1] * e2[0]};
    for (int32_t vi : {a, b, c})
      for (int k = 0; k < 3; ++k) vnorm[vi * 3 + k] += n[k];
  }

  // ---- per-vertex lambert shade (two-sided: SKIP_CULL_FACES) ------------
  std::vector<float> vshade(static_cast<size_t>(V));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < V; ++v) {
    float nx = vnorm[v * 3], ny = vnorm[v * 3 + 1], nz = vnorm[v * 3 + 2];
    const float nn = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-12f;
    nx /= nn; ny /= nn; nz /= nn;
    float s = ambient;
    for (int32_t l = 0; l < n_lights; ++l) {
      const float lx = lights[l * 4] - verts[v * 3];
      const float ly = lights[l * 4 + 1] - verts[v * 3 + 1];
      const float lz = lights[l * 4 + 2] - verts[v * 3 + 2];
      const float d2 = lx * lx + ly * ly + lz * lz + 1e-9f;
      const float inv = 1.0f / std::sqrt(d2);
      const float ndotl =
          std::fabs(nx * lx + ny * ly + nz * lz) * inv;  // two-sided
      s += lights[l * 4 + 3] * ndotl / std::max(d2, 1.0f);
    }
    vshade[v] = std::min(s, 1.0f);
  }

  // ---- project to pixel space -------------------------------------------
  std::vector<float> px(static_cast<size_t>(V)), py(static_cast<size_t>(V)),
      pz(static_cast<size_t>(V));
  for (int64_t v = 0; v < V; ++v) {
    const float xn = verts[v * 3] / xmag;               // camera x == 0
    const float yn = (verts[v * 3 + 1] - cam_y) / ymag;
    px[v] = (xn * 0.5f + 0.5f) * width;
    py[v] = (0.5f - yn * 0.5f) * height;
    pz[v] = cam_z - verts[v * 3 + 2];                    // depth, smaller=near
  }

  // ---- bin triangles into row bands so bands parallelize race-free ------
  constexpr int kBand = 16;
  const int n_bands = (height + kBand - 1) / kBand;
  std::vector<std::vector<int32_t>> bands(n_bands);
  for (int64_t f = 0; f < F; ++f) {
    const int32_t a = faces[f * 3], b = faces[f * 3 + 1], c = faces[f * 3 + 2];
    const float y0 = std::min({py[a], py[b], py[c]});
    const float y1 = std::max({py[a], py[b], py[c]});
    int b0 = static_cast<int>(std::floor(y0)) / kBand;
    int b1 = static_cast<int>(std::ceil(y1)) / kBand;
    b0 = std::max(b0, 0);
    b1 = std::min(b1, n_bands - 1);
    for (int bb = b0; bb <= b1; ++bb) bands[bb].push_back(f);
  }

  std::memset(out_rgb, 255, static_cast<size_t>(width) * height * 3);
  std::vector<float> zbuf(static_cast<size_t>(width) * height, 3.0e38f);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (int band = 0; band < n_bands; ++band) {
    const int row0 = band * kBand;
    const int row1 = std::min(row0 + kBand, height);
    for (const int32_t f : bands[band]) {
      const int32_t a = faces[f * 3], b = faces[f * 3 + 1],
                    c = faces[f * 3 + 2];
      const float ax = px[a], ay = py[a], bx = px[b], by = py[b], cx = px[c],
                  cy = py[c];
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      if (std::fabs(area) < 1e-9f) continue;
      const float inv_area = 1.0f / area;
      const int x0 = std::max(0, static_cast<int>(
                                     std::floor(std::min({ax, bx, cx}))));
      const int x1 = std::min(width - 1, static_cast<int>(std::ceil(
                                             std::max({ax, bx, cx}))));
      const int y0 = std::max(row0, static_cast<int>(
                                        std::floor(std::min({ay, by, cy}))));
      const int y1 = std::min(row1 - 1, static_cast<int>(std::ceil(
                                            std::max({ay, by, cy}))));
      for (int y = y0; y <= y1; ++y) {
        const float fy = y + 0.5f;
        for (int x = x0; x <= x1; ++x) {
          const float fx = x + 0.5f;
          const float w0 =
              ((bx - fx) * (cy - fy) - (by - fy) * (cx - fx)) * inv_area;
          const float w1 =
              ((cx - fx) * (ay - fy) - (cy - fy) * (ax - fx)) * inv_area;
          const float w2 = 1.0f - w0 - w1;
          if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;
          const float z = w0 * pz[a] + w1 * pz[b] + w2 * pz[c];
          if (z <= 0.01f) continue;  // behind the camera / past near plane
          const size_t pix = static_cast<size_t>(y) * width + x;
          if (z >= zbuf[pix]) continue;
          zbuf[pix] = z;
          const float s = w0 * vshade[a] + w1 * vshade[b] + w2 * vshade[c];
          for (int k = 0; k < 3; ++k) {
            const float cchan = std::min(std::max(s * base_color[k], 0.0f),
                                         1.0f);
            out_rgb[pix * 3 + k] = static_cast<uint8_t>(cchan * 255.0f + 0.5f);
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

// Native host-side image preprocessing for the input pipeline.
//
// The reference's input parallelism is torch's native DataLoader worker pool
// (himanshu/hi_main.py:150-151, num_workers=16) feeding HF's ViTImageProcessor,
// whose resize is Pillow's fixed-point separable resampler. This file is the
// framework's own native equivalent: a from-scratch reimplementation of the
// same resampling ALGORITHM (triangle filter, 8-bit fixed-point coefficients,
// horizontal-then-vertical passes — the documented behavior of Pillow's
// Resample.c, reproduced bit-exactly and verified byte-for-byte against PIL
// in the tests), fused with the normalize(+mean/std)+CHW-transpose
// epilogue so a batch takes ONE pass over memory instead of the PIL path's
// resize -> asarray -> /255 -> -mean -> /std -> transpose -> stack chain.
// Multithreaded over images (std::thread); built on demand by
// native/__init__.py beside it with g++ and bound via ctypes.
//
// Semantics anchor: data/preprocess.py::pil_preprocess (the exact
// HF-processor path) — the native path must produce bit-identical float32.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Fixed-point precision of the 8-bit resampling path (Pillow: 32 - 8 - 2).
constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> PRECISION_BITS);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Per-output-pixel source window [xmin, xmin+xmax) and fixed-point weights.
// Mirrors the coefficient construction of the standard separable resampler:
// support scales with the downscale factor; weights are normalized in double
// then rounded half-away-from-zero into int32 at PRECISION_BITS.
struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // [outSize * 2] : xmin, xmax pairs
  std::vector<int32_t> kk;   // [outSize * ksize]
};

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs co;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support = 1
  co.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  co.bounds.resize(static_cast<size_t>(out_size) * 2);
  std::vector<double> prekk(static_cast<size_t>(out_size) * co.ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * co.ksize];
    double wsum = 0.0;
    int x = 0;
    for (; x < xmax; ++x) {
      const double w = triangle_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      wsum += w;
    }
    for (x = 0; x < xmax; ++x) {
      if (wsum != 0.0) k[x] /= wsum;
    }
    co.bounds[static_cast<size_t>(xx) * 2] = xmin;
    co.bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }
  co.kk.resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); ++i) {
    const double v = prekk[i] * (1 << PRECISION_BITS);
    co.kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
  }
  return co;
}

// Horizontal pass: [h, w_in, c] u8 -> [h, w_out, c] u8.
void resample_horizontal(const uint8_t* in, int h, int w_in, int c,
                         uint8_t* out, int w_out, const Coeffs& co) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = in + static_cast<size_t>(yy) * w_in * c;
    uint8_t* orow = out + static_cast<size_t>(yy) * w_out * c;
    for (int xx = 0; xx < w_out; ++xx) {
      const int xmin = co.bounds[static_cast<size_t>(xx) * 2];
      const int xmax = co.bounds[static_cast<size_t>(xx) * 2 + 1];
      const int32_t* k = &co.kk[static_cast<size_t>(xx) * co.ksize];
      for (int ch = 0; ch < c; ++ch) {
        int acc = 1 << (PRECISION_BITS - 1);
        for (int x = 0; x < xmax; ++x) {
          acc += row[static_cast<size_t>(xmin + x) * c + ch] * k[x];
        }
        orow[static_cast<size_t>(xx) * c + ch] = clip8(acc);
      }
    }
  }
}

// Vertical pass: [h_in, w, c] u8 -> [h_out, w, c] u8.
void resample_vertical(const uint8_t* in, int h_in, int w, int c,
                       uint8_t* out, int h_out, const Coeffs& co) {
  for (int yy = 0; yy < h_out; ++yy) {
    const int ymin = co.bounds[static_cast<size_t>(yy) * 2];
    const int ymax = co.bounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &co.kk[static_cast<size_t>(yy) * co.ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * c;
    for (int xx = 0; xx < w * c; ++xx) {
      int acc = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < ymax; ++y) {
        acc += in[(static_cast<size_t>(ymin + y) * w * c) + xx] * k[y];
      }
      orow[xx] = clip8(acc);
    }
  }
}

// One image: [h, w, c] u8 -> [oh, ow, c] u8 (horizontal pass first, like the
// reference resampler), using shared coefficient tables + a caller-provided
// scratch buffer of h * ow * c bytes.
void resize_one(const uint8_t* in, int h, int w, int c, uint8_t* out, int oh,
                int ow, const Coeffs& ch_, const Coeffs& cv, uint8_t* scratch) {
  const bool need_h = ow != w;
  const bool need_v = oh != h;
  if (need_h && need_v) {
    resample_horizontal(in, h, w, c, scratch, ow, ch_);
    resample_vertical(scratch, h, ow, c, out, oh, cv);
  } else if (need_h) {
    resample_horizontal(in, h, w, c, out, ow, ch_);
  } else if (need_v) {
    resample_vertical(in, h, w, c, out, oh, cv);
  } else {
    std::memcpy(out, in, static_cast<size_t>(h) * w * c);
  }
}

void parallel_images(int n, int nthreads, const std::function<void(int, int)>& body) {
  int tcount = nthreads > 0 ? nthreads
                            : static_cast<int>(std::thread::hardware_concurrency());
  if (tcount < 1) tcount = 1;
  tcount = std::min(tcount, n);
  if (tcount <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(tcount);
  const int per = (n + tcount - 1) / tcount;
  for (int t = 0; t < tcount; ++t) {
    const int lo = t * per;
    const int hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(body, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Batch resize: in [n, h, w, c] u8 (contiguous) -> out [n, oh, ow, c] u8.
// Returns 0 on success.
int resize_bilinear_u8(const uint8_t* in, int n, int h, int w, int c,
                       uint8_t* out, int oh, int ow, int nthreads) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return 1;
  const Coeffs ch_ = precompute_coeffs(w, ow);
  const Coeffs cv = precompute_coeffs(h, oh);
  const size_t in_stride = static_cast<size_t>(h) * w * c;
  const size_t out_stride = static_cast<size_t>(oh) * ow * c;
  const size_t scratch_sz = static_cast<size_t>(h) * ow * c;
  parallel_images(n, nthreads, [&](int lo, int hi) {
    std::vector<uint8_t> scratch(scratch_sz);
    for (int i = lo; i < hi; ++i) {
      resize_one(in + i * in_stride, h, w, c, out + i * out_stride, oh, ow,
                 ch_, cv, scratch.data());
    }
  });
  return 0;
}

// Fused ViT preprocess: in [n, h, w, 3] u8 -> out [n, 3, size, size] f32,
// value = ((u8 / 255.0f) - mean) / stddev — the same float32 op sequence as
// data/preprocess.py::pil_preprocess, applied to the bit-exact resized bytes.
int preprocess_u8(const uint8_t* in, int n, int h, int w, float* out, int size,
                  float mean, float stddev, int nthreads) {
  if (n < 1 || h < 1 || w < 1 || size < 1) return 1;
  constexpr int C = 3;
  const Coeffs ch_ = precompute_coeffs(w, size);
  const Coeffs cv = precompute_coeffs(h, size);
  const size_t in_stride = static_cast<size_t>(h) * w * C;
  const size_t plane = static_cast<size_t>(size) * size;
  const size_t out_stride = plane * C;
  const size_t scratch_sz = static_cast<size_t>(h) * size * C;
  // lookup table: u8 -> normalized float (256 entries, exact float32 chain)
  float lut[256];
  for (int v = 0; v < 256; ++v) {
    lut[v] = ((static_cast<float>(v) / 255.0f) - mean) / stddev;
  }
  parallel_images(n, nthreads, [&](int lo, int hi) {
    std::vector<uint8_t> scratch(scratch_sz);
    std::vector<uint8_t> resized(plane * C);
    for (int i = lo; i < hi; ++i) {
      resize_one(in + i * in_stride, h, w, C, resized.data(), size, size, ch_,
                 cv, scratch.data());
      float* o = out + i * out_stride;
      for (size_t p = 0; p < plane; ++p) {
        const uint8_t* px = &resized[p * C];
        o[p] = lut[px[0]];
        o[plane + p] = lut[px[1]];
        o[2 * plane + p] = lut[px[2]];
      }
    }
  });
  return 0;
}

}  // extern "C"

// Native input-pipeline hot loop: batched RandomCrop(pad) +
// RandomHorizontalFlip + normalize, uint8 NHWC -> float32 NHWC (the
// port's own copy of the reference package's native/augment.cpp).
//
// One C call per batch, a std::thread pool inside honoring the CLI's
// `-j/--workers`, and the GIL released for the whole call (ctypes does
// this), so the loader's prefetch thread overlaps augmentation with the
// device step.
//
// Randomness (crop offsets, flips) stays in Python/NumPy: the caller
// passes per-image ys/xs/flips, which keeps the native path bit-exact
// with the NumPy implementation in data/loader.py (same f32 op order;
// tests/test_torch_port_data.py) and the augmentation stream
// independent of the backend.
//
// Build: g++ -O3 -shared -fPIC -pthread, at first use (native/__init__.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One image: crop h x w window at (y0, x0) from the zero-padded
// (h + 2p) x (w + 2p) virtual canvas, optional horizontal flip, then
// (x / 255 - mean[c]) / std[c]. Reads clamp to the real image; the
// padded border contributes (0 - mean) / std exactly like np.pad zeros.
void one_image(const uint8_t* img, int h, int w, int c, int pad,
               int y0, int x0, bool flip,
               const float* mean, const float* stddev, float* out) {
  for (int y = 0; y < h; ++y) {
    const int sy = y + y0 - pad;  // source row in the unpadded image
    const bool row_ok = (sy >= 0 && sy < h);
    for (int x = 0; x < w; ++x) {
      const int ox = flip ? (w - 1 - x) : x;
      float* dst = out + (static_cast<int64_t>(y) * w + ox) * c;
      const int sx = x + x0 - pad;
      if (row_ok && sx >= 0 && sx < w) {
        const uint8_t* src =
            img + (static_cast<int64_t>(sy) * w + sx) * c;
        for (int ch = 0; ch < c; ++ch) {
          // Same f32 op sequence as the NumPy reference
          // ((x / 255.0 - mean) / std) => bit-exact parity.
          dst[ch] = (static_cast<float>(src[ch]) / 255.0f - mean[ch]) /
                    stddev[ch];
        }
      } else {
        for (int ch = 0; ch < c; ++ch) {
          dst[ch] = (0.0f - mean[ch]) / stddev[ch];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// images: (n, h, w, c) uint8, contiguous. ys/xs: (n,) int32 crop
// offsets in [0, 2*pad]. flips: (n,) uint8. mean/stddev: (c,) float32.
// out: (n, h, w, c) float32. workers: thread count (<=1 = inline).
void dmp_augment_normalize(const uint8_t* images, int n, int h, int w,
                           int c, const int32_t* ys, const int32_t* xs,
                           const uint8_t* flips, int pad,
                           const float* mean, const float* stddev,
                           float* out, int workers) {
  const int64_t img_in = static_cast<int64_t>(h) * w * c;
  const int64_t img_out = img_in;

  auto run = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      one_image(images + i * img_in, h, w, c, pad, ys[i], xs[i],
                flips[i] != 0, mean, stddev, out + i * img_out);
    }
  };

  if (workers <= 1 || n < 2) {
    run(0, n);
    return;
  }
  const int t = workers < n ? workers : n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  const int chunk = (n + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    const int lo = k * chunk;
    const int hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Normalize-only variant (val path: no crop/flip).
void dmp_normalize(const uint8_t* images, int n, int h, int w, int c,
                   const float* mean, const float* stddev, float* out,
                   int workers) {
  const int64_t sz = static_cast<int64_t>(n) * h * w * c;
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int ch = static_cast<int>(i % c);
      out[i] = (static_cast<float>(images[i]) / 255.0f - mean[ch]) /
               stddev[ch];
    }
  };
  if (workers <= 1) {
    run(0, sz);
    return;
  }
  const int t = workers;
  std::vector<std::thread> pool;
  const int64_t chunk = ((sz + t - 1) / t + c - 1) / c * c;  // align to c
  for (int k = 0; k < t; ++k) {
    const int64_t lo = k * chunk;
    const int64_t hi = lo + chunk < sz ? lo + chunk : sz;
    if (lo >= hi) break;
    pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"

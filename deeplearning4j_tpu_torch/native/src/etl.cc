// Host-side ETL kernels for the data-loader path.
//
// Reference analog: the native side of DL4J's ETL — DataVec image loaders +
// the workspace-backed prefetch in AsyncDataSetIterator.java (SURVEY.md §2.1
// dataset-iterator row) do their byte->float conversion in libnd4j. Here the
// hot host-side conversions (uint8 image -> normalized float32, label ->
// one-hot) run in C++ with a simple thread fan-out so the prefetch thread
// keeps up with the device.

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void run_parallel(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || n < (int64_t)1 << 16) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// dst[i] = src[i] * scale + bias  (e.g. scale=1/255 for image normalization)
void dl4j_u8_to_f32(const uint8_t* src, float* dst, int64_t n, float scale,
                    float bias, int threads) {
  run_parallel(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = (float)src[i] * scale + bias;
  });
}

// One-hot encode int32 labels into a zeroed [n, k] float32 matrix.
void dl4j_one_hot(const int32_t* labels, float* out, int64_t n, int64_t k) {
  std::memset(out, 0, (size_t)(n * k) * sizeof(float));
  for (int64_t i = 0; i < n; ++i) {
    int64_t c = labels[i];
    if (c >= 0 && c < k) out[i * k + c] = 1.0f;
  }
}

// Gather rows: out[i] = src[index[i]] for row size `row` floats — the
// host-side minibatch assembly (shuffled epoch order) without numpy fancy-
// indexing overhead. Out-of-range indices zero-fill their row (the Python
// wrapper validates and raises first; this is the memory-safety backstop).
void dl4j_gather_rows_f32(const float* src, const int64_t* index, float* out,
                          int64_t n_rows, int64_t row, int64_t n_src,
                          int threads) {
  run_parallel(n_rows, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t j = index[i];
      if (j < 0 || j >= n_src) {
        std::memset(out + i * row, 0, (size_t)row * sizeof(float));
      } else {
        std::memcpy(out + i * row, src + j * row,
                    (size_t)row * sizeof(float));
      }
    }
  });
}

// NCHW (reference layout) -> NHWC (the framework's layout) for a float32 batch.
void dl4j_nchw_to_nhwc(const float* src, float* dst, int64_t n, int64_t c,
                       int64_t h, int64_t w, int threads) {
  run_parallel(n, threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* s = src + i * c * h * w;
      float* d = dst + i * h * w * c;
      for (int64_t ch = 0; ch < c; ++ch)
        for (int64_t y = 0; y < h; ++y)
          for (int64_t x = 0; x < w; ++x)
            d[(y * w + x) * c + ch] = s[(ch * h + y) * w + x];
    }
  });
}

}  // extern "C"

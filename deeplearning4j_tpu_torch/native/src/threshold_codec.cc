// Threshold gradient compression codec.
//
// Reference analog: the C++ "THRESHOLD" NDArrayCompressor in libnd4j used by
// EncodingHandler.java:28 (sparse +-tau messages with bitmap fallback and
// adaptive threshold) — see SURVEY.md §2.3. Re-designed for the
// host-side gradient-compression path: the encoder extracts the +-tau
// contribution of every element whose |g| >= tau into a compact message and
// leaves the residual in place, so repeated encode calls implement the
// reference's residual-accumulation semantics exactly.
//
// Sparse message layout: int32 per flagged element, value = (index+1) for
// +tau and -(index+1) for -tau (the same signed-index trick nd4j uses).
// Bitmap fallback: 2 bits per element (00 none, 01 +tau, 10 -tau), used by
// the Python wrapper when > ~1/6 of elements flag (sparse would be larger).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Encode into sparse signed indices. Returns the number of flagged elements
// written, or -(needed) if more than `cap` elements flag (nothing is written
// and grad is untouched in that case, so the caller can retry with a bitmap).
int64_t dl4j_encode_threshold(float* grad, int64_t n, float tau,
                              int32_t* out, int64_t cap) {
  // first pass: count (cheap, branch-predictable)
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (std::fabs(grad[i]) >= tau) ++count;
  }
  if (count > cap) return -count;
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    float g = grad[i];
    if (g >= tau) {
      out[w++] = (int32_t)(i + 1);
      grad[i] = g - tau;
    } else if (g <= -tau) {
      out[w++] = (int32_t)(-(i + 1));
      grad[i] = g + tau;
    }
  }
  return w;
}

// Decode sparse message: target[idx] += +-tau. Safe to call repeatedly for
// accumulating many workers' messages into one buffer.
void dl4j_decode_threshold(const int32_t* enc, int64_t count, float tau,
                           float* target, int64_t n) {
  for (int64_t i = 0; i < count; ++i) {
    int32_t v = enc[i];
    if (v > 0) {
      int64_t idx = (int64_t)v - 1;
      if (idx < n) target[idx] += tau;
    } else if (v < 0) {
      int64_t idx = (int64_t)(-v) - 1;
      if (idx < n) target[idx] -= tau;
    }
  }
}

// Bitmap encode: out must hold (n+15)/16 uint32 words (2 bits/element).
// Always succeeds; returns flagged count. Residual semantics as above.
int64_t dl4j_encode_bitmap(float* grad, int64_t n, float tau, uint32_t* out) {
  int64_t words = (n + 15) / 16;
  std::memset(out, 0, (size_t)words * 4);
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    float g = grad[i];
    uint32_t code = 0;
    if (g >= tau) {
      code = 1u;
      grad[i] = g - tau;
      ++count;
    } else if (g <= -tau) {
      code = 2u;
      grad[i] = g + tau;
      ++count;
    }
    if (code) out[i / 16] |= code << (2 * (i % 16));
  }
  return count;
}

void dl4j_decode_bitmap(const uint32_t* bitmap, int64_t n, float tau,
                        float* target) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t code = (bitmap[i / 16] >> (2 * (i % 16))) & 3u;
    if (code == 1u) target[i] += tau;
    else if (code == 2u) target[i] -= tau;
  }
}

}  // extern "C"

// Convolution with fused batch-norm statistics for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/conv_pallas.py:
//   _mm_stats_kernel       (1x1 convs, driven by _matmul_stats)   -> conv_mm_stats_*
//   _conv3x3_stats_kernel  (SAME 3x3 convs, driven by _conv3x3_stats) -> conv3x3_stats_*
//
// Contract, for x [B,H,W,Cin] NHWC, w [KS,KS,Cin,Cout] HWIO (KS = 1 or 3),
// strides (sh, sw) and top/left pad p, one output row m per output pixel
// (b, ho, wo):
//   acc[m, n] = sum_{dh, dw, ci} x[b, ho*sh + dh - p, wo*sw + dw - p, ci] * w[dh, dw, ci, n]
//               with taps outside the image reading 0; f32 accumulation
//   z[m, n]   = acc[m, n] rounded to x's dtype (written once)
//   stats[0, n] = sum_m acc[m, n],   stats[1, n] = sum_m acc[m, n]^2
//               both in f32 from the UNROUNDED accumulator
// Geometries: 1x1 at any stride, p = 0, Ho = ceil(H / sh) (the strided input
// is read in place, no pre-slice copy); 3x3 at stride 1 with p = 1 (SAME,
// pads (1, 1)); 3x3 at stride 2 on even H, W with p = 0 (XLA's SAME pads
// (0, 1): the high pad is the bounds check reading 0).
//
// What bounds it: the product, 2*M*KS*KS*Cin*Cout operations against
// (x + w + z) elements moved once. At the ResNet50 shapes (batch 64, 224^2)
// every call is operation-bound on the H100: 479 GFLOP per forward over the
// 52 calls, ~7.1 ms on the CUDA cores' 67 TFLOP/s in f32.
//
// Design (simple and right first; wgmma, TMA and pipelining come later):
// one implicit GEMM for both kernels. A block owns a 128-pixel x 64-channel
// output tile and walks K as (tap, channel chunk): for each tap it reads
// the shifted input rows through a per-block table of (b, ho*sh - p,
// wo*sw - p), with bounds checks instead of a padded copy, and stages the A
// and B tiles in shared memory. f32 runs its FMAs on the CUDA cores (no
// TF32: it would break the f32 tolerance): the A tile is staged transposed
// as f32, 16 channels a step, and 256 threads each hold an 8 x 4 f32
// accumulator patch in registers. bf16 runs on the tensor cores through
// WMMA 16x16x16 bf16 fragments with f32 accumulators: the tiles stay bf16,
// 32 channels a step, loaded 16 bytes a thread where Cin (and Cout) is a
// multiple of 8, and each of the 8 warps owns a 32 x 32 patch (2 x 2
// fragments); the accumulators then pass through shared memory into the
// same 8 x 4 per-thread layout as f32. The epilogue, common to both,
// writes z and reduces the block's per-channel sum and sum of squares from
// the f32 accumulators (registers, then a warp shuffle, then the 8 warps
// in order) into a [row_tiles, 2, Cout] partials buffer; a second small
// kernel sums the partials over row tiles in a fixed order, so the
// statistics are deterministic run to run (no float atomics). The TPU
// kernel's 128-lane padding, 8-row stats block, jnp.pad copies and
// sequential (j, i, k) grid are TPU artefacts and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 16;        // input channels per K step (f32)
constexpr int kWBK = 32;       // input channels per K step (bf16, WMMA)
constexpr int kThreads = 256;  // 16 x 16 threads, each 8 rows x 4 channels
constexpr int kWarps = kThreads / 32;
constexpr int kALd = kWBK + 8;  // bf16 A tile row stride (elements)
constexpr int kBLd = kBN + 8;   // bf16 B tile row stride
constexpr int kCLd = kBN + 4;   // f32 accumulator tile row stride

struct Params {
  const void* x;
  const void* w;
  void* z;
  float* partials;
  int B, H, W, Cin, Ho, Wo, Cout, sh, sw, pad, M;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The block's output rows as (b, ho*sh - pad, wo*sw - pad); b = -1 past M.
struct RowTable {
  int b[kBM], h[kBM], w[kBM];
};

__device__ __forceinline__ void fill_rows(RowTable& rt, const Params& p, int m0) {
  const int tid = threadIdx.x;
  if (tid >= kBM) return;
  const int m = m0 + tid;
  if (m < p.M) {
    const int hw = p.Ho * p.Wo;
    const int b = m / hw, rem = m - b * hw;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    rt.b[tid] = b;
    rt.h[tid] = ho * p.sh - p.pad;
    rt.w[tid] = wo * p.sw - p.pad;
  } else {
    rt.b[tid] = -1;
    rt.h[tid] = 0;
    rt.w[tid] = 0;
  }
}

// Offset of x[b, hi, wi, 0] for tile row r at tap (dh, dw), or -1 when the
// row is past M or the tap falls outside the image (it reads 0).
__device__ __forceinline__ long long tap_offset(const RowTable& rt, const Params& p, int r, int dh,
                                                int dw) {
  const int b = rt.b[r];
  if (b < 0) return -1;
  const int hi = rt.h[r] + dh, wi = rt.w[r] + dw;
  if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return ((static_cast<long long>(b) * p.H + hi) * p.W + wi) * p.Cin;
}

// Writes z for the thread's 8 x 4 patch (rows ty*8 + i, channels tx*4 + j)
// and the block's per-channel [sum, sum of squares] of acc into partials.
template <typename T>
__device__ __forceinline__ void epilogue(const float (&acc)[8][4], const Params& p, int m0, int n0,
                                         float (*red)[2][kBN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  T* z = static_cast<T*>(p.z);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < p.Cout) z[static_cast<long long>(m) * p.Cout + col] = from_f<T>(acc[i][j]);
      s1[j] += acc[i][j];
      s2[j] += acc[i][j] * acc[i][j];
    }
  }
  // lanes l and l ^ 16 hold the same channels (rows ty and ty + 1)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 16);
    s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 16);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[warp][0][tx * 4 + j] = s1[j];
      red[warp][1][tx * 4 + j] = s2[j];
    }
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int stat = tid / kBN, n = tid % kBN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][stat][n];
    if (n0 + n < p.Cout) {
      p.partials[(static_cast<long long>(blockIdx.x) * 2 + stat) * p.Cout + n0 + n] = s;
    }
  }
}

// f32: FMAs on the CUDA cores.
template <int KS>
__global__ void __launch_bounds__(kThreads) conv_stats_f32_kernel(Params p) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // A tile, transposed
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ RowTable rt;
  __shared__ float red[kWarps][2][kBN];

  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  fill_rows(rt, p, m0);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int a_k = tid & 15;   // the A-tile channel this thread loads
  const int a_r0 = tid >> 4;  // its first A-tile row (then every 16th)

  for (int tap = 0; tap < KS * KS; ++tap) {
    const int dh = tap / KS, dw = tap % KS;
    for (int c0 = 0; c0 < p.Cin; c0 += kBK) {
      __syncthreads();  // the previous step's readers are done (and the row table is set)
      const int ci = c0 + a_k;
#pragma unroll
      for (int e = 0; e < kBM / 16; ++e) {
        const int r = a_r0 + 16 * e;
        const long long off = ci < p.Cin ? tap_offset(rt, p, r, dh, dw) : -1;
        As[a_k][r] = off >= 0 ? x[off + ci] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kBK * kBN / kThreads; ++e) {
        const int idx = tid + kThreads * e;
        const int kk = idx / kBN, n = idx % kBN;
        const int cw = c0 + kk, col = n0 + n;
        Bs[kk][n] = (cw < p.Cin && col < p.Cout)
                        ? w[(static_cast<long long>(tap) * p.Cin + cw) * p.Cout + col]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
  }
  epilogue<float>(acc, p, m0, n0, red);
}

// bf16: WMMA 16x16x16 on the tensor cores, f32 accumulators. VEC: Cin and
// Cout are multiples of 8, so tiles load 8 bf16 (16 bytes) a thread.
template <int KS, bool VEC>
__global__ void __launch_bounds__(kThreads) conv_stats_bf16_kernel(Params p) {
  using namespace nvcuda;
  constexpr int kTileBytes = (kBM * kALd + kWBK * kBLd) * 2;
  constexpr int kAccBytes = kBM * kCLd * 4;
  __shared__ __align__(32) unsigned char tiles[kTileBytes > kAccBytes ? kTileBytes : kAccBytes];
  __shared__ RowTable rt;
  __shared__ float red[kWarps][2][kBN];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(tiles);  // [kBM][kALd]
  __nv_bfloat16* Bs = As + kBM * kALd;                          // [kWBK][kBLd]
  float* Cs = reinterpret_cast<float*>(tiles);                   // [kBM][kCLd], after the K loop

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 patch
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  fill_rows(rt, p, m0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_f[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_f[i][j], 0.f);

  for (int tap = 0; tap < KS * KS; ++tap) {
    const int dh = tap / KS, dw = tap % KS;
    for (int c0 = 0; c0 < p.Cin; c0 += kWBK) {
      __syncthreads();
      if (VEC) {
        // A: 128 rows x 4 chunks of 8 channels; B: 32 rows x 8 chunks
#pragma unroll
        for (int e = 0; e < kBM * kWBK / 8 / kThreads; ++e) {
          const int q = tid + kThreads * e;
          const int r = q >> 2, cc = (q & 3) * 8, ci = c0 + cc;
          const long long off = ci < p.Cin ? tap_offset(rt, p, r, dh, dw) : -1;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (off >= 0) v = *reinterpret_cast<const uint4*>(x + off + ci);
          *reinterpret_cast<uint4*>(As + r * kALd + cc) = v;
        }
        {
          const int kk = tid >> 3, nn = (tid & 7) * 8;
          const int cw = c0 + kk, col = n0 + nn;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (cw < p.Cin && col < p.Cout) {
            v = *reinterpret_cast<const uint4*>(
                w + (static_cast<long long>(tap) * p.Cin + cw) * p.Cout + col);
          }
          *reinterpret_cast<uint4*>(Bs + kk * kBLd + nn) = v;
        }
      } else {
#pragma unroll 4
        for (int e = 0; e < kBM * kWBK / kThreads; ++e) {
          const int q = tid + kThreads * e;
          const int r = q / kWBK, kk = q % kWBK, ci = c0 + kk;
          const long long off = ci < p.Cin ? tap_offset(rt, p, r, dh, dw) : -1;
          As[r * kALd + kk] = off >= 0 ? x[off + ci] : zero;
        }
#pragma unroll 4
        for (int e = 0; e < kWBK * kBN / kThreads; ++e) {
          const int q = tid + kThreads * e;
          const int kk = q / kBN, n = q % kBN;
          const int cw = c0 + kk, col = n0 + n;
          Bs[kk * kBLd + n] = (cw < p.Cin && col < p.Cout)
                                  ? w[(static_cast<long long>(tap) * p.Cin + cw) * p.Cout + col]
                                  : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_f[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b_f[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(a_f[i], As + (wm * 32 + i * 16) * kALd + kk, kALd);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(b_f[j], Bs + kk * kBLd + wn * 32 + j * 16, kBLd);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc_f[i][j], a_f[i], b_f[j], acc_f[i][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with the tiles: reuse them for Cs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16, acc_f[i][j],
                              kCLd, wmma::mem_row_major);
    }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(Cs + (ty * 8 + i) * kCLd + tx * 4);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }
  epilogue<__nv_bfloat16>(acc, p, m0, n0, red);
}

// stats[stat, c] = sum over row tiles i of partials[i, stat, c], in a fixed
// order: 8 row groups per column each sum every 8th tile, then group 0 adds
// the 8 group sums in order.
__global__ void __launch_bounds__(256) reduce_partials_kernel(const float* partials, float* stats,
                                                              int row_tiles, int Cout) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int stat = blockIdx.y;
  float s = 0.f;
  if (c < Cout) {
    for (int i = g; i < row_tiles; i += 8) {
      s += partials[(static_cast<long long>(i) * 2 + stat) * Cout + c];
    }
  }
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && c < Cout) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[q][lane];
    stats[stat * Cout + c] = t;
  }
}

template <typename T, int KS>
int run(const void* x, const void* w, void* z, void* partials, void* stats, int B, int H, int W,
        int Cin, int Cout, int sh, int sw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || sh < 1 || sw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int pad, Ho, Wo;
  if (KS == 1) {
    pad = 0;
    Ho = (H + sh - 1) / sh;
    Wo = (W + sw - 1) / sw;
  } else if (sh == 1 && sw == 1) {
    pad = 1;
    Ho = H;
    Wo = W;
  } else if (sh == 2 && sw == 2 && H % 2 == 0 && W % 2 == 0) {
    pad = 0;
    Ho = H / 2;
    Wo = W / 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m_ll = static_cast<long long>(B) * Ho * Wo;
  if (m_ll > 0x7fffffffLL - kBM || static_cast<long long>(B) * H * W * Cin > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = static_cast<int>(m_ll);
  const int row_tiles = (M + kBM - 1) / kBM;
  if ((Cout + kBN - 1) / kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, z, static_cast<float*>(partials), B, H, W, Cin, Ho, Wo, Cout, sh, sw, pad, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_tiles, (Cout + kBN - 1) / kBN);
  if constexpr (sizeof(T) == 4) {
    conv_stats_f32_kernel<KS><<<grid, kThreads, 0, s>>>(p);
  } else if (Cin % 8 == 0 && Cout % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    conv_stats_bf16_kernel<KS, true><<<grid, kThreads, 0, s>>>(p);
  } else {
    conv_stats_bf16_kernel<KS, false><<<grid, kThreads, 0, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((Cout + 31) / 32, 2);
  reduce_partials_kernel<<<rgrid, 256, 0, s>>>(static_cast<const float*>(partials),
                                              static_cast<float*>(stats), row_tiles, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,Cin] NHWC contiguous, w [KS,KS,Cin,Cout] HWIO contiguous, both in
// the entry point's dtype; z [B,Ho,Wo,Cout] contiguous in that dtype;
// partials [ceil(B*Ho*Wo / row_tile), 2, Cout] f32 scratch; stats [2, Cout]
// f32. Returns the first cudaError_t met (0 on success).
extern "C" int conv_mm_stats_f32(const void* x, const void* w, void* z, void* partials,
                                 void* stats, int B, int H, int W, int Cin, int Cout, int sh,
                                 int sw, int device, void* stream) {
  return run<float, 1>(x, w, z, partials, stats, B, H, W, Cin, Cout, sh, sw, device, stream);
}

extern "C" int conv_mm_stats_bf16(const void* x, const void* w, void* z, void* partials,
                                  void* stats, int B, int H, int W, int Cin, int Cout, int sh,
                                  int sw, int device, void* stream) {
  return run<__nv_bfloat16, 1>(x, w, z, partials, stats, B, H, W, Cin, Cout, sh, sw, device,
                               stream);
}

extern "C" int conv3x3_stats_f32(const void* x, const void* w, void* z, void* partials,
                                 void* stats, int B, int H, int W, int Cin, int Cout, int sh,
                                 int sw, int device, void* stream) {
  return run<float, 3>(x, w, z, partials, stats, B, H, W, Cin, Cout, sh, sw, device, stream);
}

extern "C" int conv3x3_stats_bf16(const void* x, const void* w, void* z, void* partials,
                                  void* stats, int B, int H, int W, int Cin, int Cout, int sh,
                                  int sw, int device, void* stream) {
  return run<__nv_bfloat16, 3>(x, w, z, partials, stats, B, H, W, Cin, Cout, sh, sw, device,
                               stream);
}

// Output pixels per block: the partials buffer has ceil(B*Ho*Wo / row_tile) rows.
extern "C" int conv_stats_row_tile() { return kBM; }

extern "C" const char* conv_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Convolution with fused batch-norm statistics for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of deeplearning4j_tpu/ops/conv_pallas.py:
//   _mm_stats_kernel       (:86, 1x1 convs, driven by _matmul_stats)    -> ks = 1
//   _conv3x3_stats_kernel  (:169, SAME 3x3 convs, driven by _conv3x3_stats) -> ks = 3
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
// What bounds each call on this card (H100 SXM: 989 TFLOP/s bf16 on the
// tensor cores, 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): 2*M*KS*KS*
// Cin*Cout operations against x, w and z moved once. In f32 every
// ResNet50 call (batch 64, 224^2) is bound by operations. In bf16 the 3x3
// calls stay bound by operations while most 1x1 calls, at 32-410
// operations per byte, are bound by bytes, and z, the largest array, is
// most of those.
//
// Design. Every variant is one implicit GEMM: output tile = BM pixels x BN
// channels (BN = 64 where Cout <= 64, else 128), K walked as (tap, channel
// chunk), A the input rows at the tap's offset with zeros off the image
// (no padded copy; a strided 1x1 reads x in place), B the HWIO weights read
// as a plain [KS*KS*Cin, Cout] matrix. The grid is persistent: block i
// takes output tiles i, i + grid, i + 2 grid, ... (row tile = tile /
// col_tiles); ops/conv_stats.py plan() chooses variant, tile and grid from
// the shape, and conv_stats_launch validates the choice.
//
// bf16_wgmma (Cin % 8 == 0, Cout % 8 == 0, 16-byte aligned x, w, z): a
// 128 x BN tile, 288 threads: two consumer warpgroups, each issuing
// wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in registers) on its
// 64 rows, and one producer thread feeding a 4-stage ring of (A 128 x 64
// channels, B 64 x BN) tiles in shared memory through full/empty
// mbarriers. Both operands arrive by TMA with the 128-byte swizzle the
// wgmma descriptors name: A by the im2col mode (one load = 128 output
// pixels at the tap's offset, the SAME pads, strides and the batch edge
// handled by the copy engine, zeros for taps off the image, channels past
// Cin and rows past M), B by one or two tiled 64 x 64 boxes, MN-major, read
// through wgmma's transpose bit so that HWIO needs no re-layout. Consumers
// release a stage once the MMAs reading it have retired (wgmma.wait_group
// 1), so the producer stays up to four stages ahead, across tiles.
// Epilogue on the register accumulators: per-column sums across a warp's
// lanes by recursive halving (V/2 + V/4 + V/8 shuffles), then the 8 warps
// in order through shared memory; z rounded to bf16, staged in shared
// memory and stored as 16-byte vectors. Tiles stay 128 rows tall even on
// the 7x7 stage, where that leaves SMs idle: on the H100 they beat 64-row
// tiles (one consumer warpgroup, two blocks an SM) on every path geometry.
//
// f32_pipelined (Cin % 4 == 0, Cout % 4 == 0, 16-byte aligned x, w, z):
// CUDA-core FMAs (no TF32: it would break the f32 tolerance). BM x BN tile
// (128 x 128, 64 x 128 where 128 rows leave an SM without a tile, 128 x 64
// where Cout <= 64), one thread per 8 x 8 f32 patch (rows ty*4 + i and BM/2
// + ty*4 + i, channels tx*4 + j and BN/2 + tx*4 + j): 256 FMAs per 16
// LDS.128. A 3-stage cp.async ring of 16-channel K chunks: A row-major by
// 16-byte copies (each row's offset computed once per tap), B by 16-byte
// copies. The same statistics epilogue from the register patch (shuffles,
// then the warps in order).
//
// The unaligned variants, chosen from the shape before the launch and
// never on the ResNet50 path: bf16_unaligned, a 128 x 64 tile on WMMA
// 16x16x16 bf16 fragments with element-wise loads; f32_unaligned, the f32
// kernel with 4-byte copies and scalar z stores.
//
// Statistics are deterministic run to run: each tile writes its row tile's
// per-channel [sum, sum of squares] to a [row_tiles, 2, Cout] partials
// buffer (a fixed reduction order inside the tile), and
// reduce_partials_kernel sums the row tiles in a fixed order. No float
// atomics. The TPU kernels' 128-lane padding, 8-row stats block, jnp.pad
// copies and sequential (j, i, k) grid are TPU artefacts with no
// counterpart here.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

enum Variant { kBf16Wgmma = 0, kBf16Unaligned = 1, kF32Pipelined = 2, kF32Unaligned = 3 };

struct Params {
  const void* x;
  const void* w;
  void* z;
  float* partials;
  int B, H, W, Cin, Ho, Wo, Cout, sh, sw, pad, M;
  int col_tiles, tiles;  // output tiles; row tile = tile / col_tiles
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes global -> shared; src_size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// im2col: pixelsPerColumn pixels from (w, h, n) on in the map's traversal
// order, each at offset (dw, dh), channels c..c+channelsPerPixel-1
__device__ __forceinline__ void tma_im2col_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c, int w, int h, int n, int dw, int dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(static_cast<uint16_t>(dw)), "h"(static_cast<uint16_t>(dh))
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row m of the output as (b, ho*sh - pad, wo*sw - pad); b = -1 past M.
__device__ __forceinline__ void row_origin(const Params& p, int m, int& b, int& h, int& w) {
  if (m >= p.M) {
    b = -1;
    h = w = 0;
    return;
  }
  const int hw = p.Ho * p.Wo;
  b = m / hw;
  const int rem = m - b * hw;
  const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
  h = ho * p.sh - p.pad;
  w = wo * p.sw - p.pad;
}

// Element offset of x[b, h + dh, w + dw, 0], or -1 when the row is past M
// or the tap falls outside the image (it reads 0).
__device__ __forceinline__ long long tap_offset(const Params& p, int b, int h, int w, int dh,
                                                int dw) {
  if (b < 0) return -1;
  const int hi = h + dh, wi = w + dw;
  if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return ((static_cast<long long>(b) * p.H + hi) * p.W + wi) * p.Cin;
}

// ---------------------------------------------------------------------------
// bf16_unaligned: WMMA 16x16x16 fragments, element-wise tile loads
// ---------------------------------------------------------------------------

constexpr int kUBM = 128;       // output pixels per tile
constexpr int kUBN = 64;        // output channels per tile
constexpr int kUBK = 32;        // input channels per K step
constexpr int kUThreads = 256;  // 8 warps, each a 32 x 32 patch
constexpr int kUWarps = kUThreads / 32;
constexpr int kUALd = kUBK + 8;  // A tile row stride (elements)
constexpr int kUBLd = kUBN + 8;  // B tile row stride
constexpr int kUCLd = kUBN + 4;  // f32 accumulator tile row stride
constexpr int kUTileBytes = (kUBM * kUALd + kUBK * kUBLd) * 2;
constexpr int kUAccBytes = kUBM * kUCLd * 4;
constexpr int kUTilesBytes = kUTileBytes > kUAccBytes ? kUTileBytes : kUAccBytes;
constexpr int kUSmemBytes = kUTilesBytes + 3 * kUBM * 4 + kUWarps * 2 * kUBN * 4;

__global__ void __launch_bounds__(kUThreads) conv_stats_bf16_unaligned_kernel(Params p, int ks) {
  using namespace nvcuda;
  __shared__ __align__(32) unsigned char tiles[kUTilesBytes];
  __shared__ int rb[kUBM], rh[kUBM], rw[kUBM];
  __shared__ float red[kUWarps][2][kUBN];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(tiles);  // [kUBM][kUALd]
  __nv_bfloat16* Bs = As + kUBM * kUALd;                         // [kUBK][kUBLd]
  float* Cs = reinterpret_cast<float*>(tiles);                    // [kUBM][kUCLd], after the K loop

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* z = static_cast<__nv_bfloat16*>(p.z);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 patch

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int rt = tile / p.col_tiles;
    const int m0 = rt * kUBM, n0 = (tile - rt * p.col_tiles) * kUBN;
    __syncthreads();  // the previous tile's readers of the row table and tiles are done
    if (tid < kUBM) row_origin(p, m0 + tid, rb[tid], rh[tid], rw[tid]);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_f[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_f[i][j], 0.f);

    for (int tap = 0; tap < ks * ks; ++tap) {
      const int dh = tap / ks, dw = tap % ks;
      for (int c0 = 0; c0 < p.Cin; c0 += kUBK) {
        __syncthreads();
#pragma unroll 4
        for (int e = 0; e < kUBM * kUBK / kUThreads; ++e) {
          const int q = tid + kUThreads * e;
          const int r = q / kUBK, kk = q % kUBK, ci = c0 + kk;
          const long long off = ci < p.Cin ? tap_offset(p, rb[r], rh[r], rw[r], dh, dw) : -1;
          As[r * kUALd + kk] = off >= 0 ? x[off + ci] : zero;
        }
#pragma unroll 4
        for (int e = 0; e < kUBK * kUBN / kUThreads; ++e) {
          const int q = tid + kUThreads * e;
          const int kk = q / kUBN, n = q % kUBN;
          const int cw = c0 + kk, col = n0 + n;
          Bs[kk * kUBLd + n] = (cw < p.Cin && col < p.Cout)
                                   ? w[(static_cast<long long>(tap) * p.Cin + cw) * p.Cout + col]
                                   : zero;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kUBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_f[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b_f[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(a_f[i], As + (wm * 32 + i * 16) * kUALd + kk, kUALd);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(b_f[j], Bs + kk * kUBLd + wn * 32 + j * 16, kUBLd);
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
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kUCLd + wn * 32 + j * 16, acc_f[i][j],
                                kUCLd, wmma::mem_row_major);
      }
    __syncthreads();
    // each thread: rows ty*8 + i, channels tx*4 + j
    const int tx = tid & 15, ty = tid >> 4;
    float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i, m = m0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = Cs[r * kUCLd + tx * 4 + j];
        const int col = n0 + tx * 4 + j;
        if (m < p.M && col < p.Cout) z[static_cast<long long>(m) * p.Cout + col] = __float2bfloat16(v);
        s1[j] += v;
        s2[j] += v * v;
      }
    }
    // lanes l and l ^ 16 hold the same channels (rows ty and ty + 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 16);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[warp][0][tx * 4 + j] = s1[j];
        red[warp][1][tx * 4 + j] = s2[j];
      }
    }
    __syncthreads();
    if (tid < 2 * kUBN) {
      const int stat = tid / kUBN, n = tid % kUBN;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kUWarps; ++q) s += red[q][stat][n];
      if (n0 + n < p.Cout) p.partials[(static_cast<long long>(rt) * 2 + stat) * p.Cout + n0 + n] = s;
    }
  }
}

// stats[stat, c] = sum over row tiles i of partials[i, stat, c], in a fixed
// order. A block takes 32 columns of one statistic: warp g sums the row
// tiles i = g (mod 32) into four running sums (i / 32 mod 4, for loads in
// flight), adds them in order, and warp 0 adds the 32 warp sums in order.
constexpr int kRedWarps = 32;
__global__ void __launch_bounds__(32 * kRedWarps) reduce_partials_kernel(const float* partials,
                                                                         float* stats,
                                                                         int row_tiles, int Cout) {
  __shared__ float red[kRedWarps][33];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int stat = blockIdx.y;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < Cout) {
    const float* col = partials + static_cast<long long>(stat) * Cout + c;
    const long long step = 2LL * Cout;
    int i = g;
    for (; i + 3 * kRedWarps < row_tiles; i += 4 * kRedWarps) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += col[(i + u * kRedWarps) * step];
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      if (i + u * kRedWarps < row_tiles) s[u] += col[(i + u * kRedWarps) * step];
    }
  }
  red[g][lane] = (s[0] + s[1]) + (s[2] + s[3]);
  __syncthreads();
  if (g == 0 && c < Cout) {
    float t = 0.f;
#pragma unroll 8
    for (int q = 0; q < kRedWarps; ++q) t += red[q][lane];
    stats[stat * Cout + c] = t;
  }
}

// ---------------------------------------------------------------------------
// bf16_wgmma: warpgroup MMA fed by a TMA + cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStages = 4;         // ring depth
constexpr int kWBK = 64;           // input channels per K step: one 128-byte swizzle row
constexpr uint32_t kBoxBytes = kWBK * 64 * 2;  // one 64 x 64 TMA box of B

// BN = 128 (two B boxes) or 64 (Cout <= 64: one box, no idle half tile)
template <int BN>
struct WgLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int NWG = 2;  // consumer warpgroups, 64 rows each
  static constexpr int BM = 64 * NWG;
  static constexpr int S = kStages;
  static constexpr int ZLd = BN + 8;  // z staging row stride (bf16 elements)
  static constexpr uint32_t a_bytes = BM * kWBK * 2;
  static constexpr uint32_t b_bytes = kWBK * BN * 2;
  static constexpr uint32_t stage_bytes = a_bytes + b_bytes;
  static constexpr uint32_t zs = S * stage_bytes;                // [NWG][64][ZLd] bf16
  static constexpr uint32_t red = zs + NWG * 64 * ZLd * 2;        // [4 NWG][2][BN] f32
  static constexpr uint32_t bars = red + 4 * NWG * 2 * BN * 4;    // full[S], empty[S]
  static constexpr uint32_t bytes = bars + 2 * S * 8 + 1024;  // + slack to align the base
};

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the asynchronous MMA
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] (K-major) * B[16 x 128] (MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] (K-major) * B[16 x 64] (MN-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_m64n128k16(d, da, db, acc);
}
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_m64n64k16(d, da, db, acc);
}

// One halving step of fold8: lanes l and l ^ O trade halves of v[0, 2 HALF).
template <int V, int HALF, int O>
__device__ __forceinline__ void fold_step(float (&v)[V], int lane) {
  const bool hi = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? v[i] : v[i + HALF];
    const float keep = hi ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sums v over the 8 lanes that share lane % 4, by recursive halving (V/2 +
// V/4 + V/8 shuffles): lane l ends with the sums of v[base + i], i < V/8,
// in v[i], where base = (l>>4 & 1) V/2 + (l>>3 & 1) V/4 + (l>>2 & 1) V/8.
template <int V>
__device__ __forceinline__ void fold8(float (&v)[V], int lane) {
  fold_step<V, V / 2, 16>(v, lane);
  fold_step<V, V / 4, 8>(v, lane);
  fold_step<V, V / 8, 4>(v, lane);
}

// Threads [0, 256) are the two consumer warpgroups (warpgroup g owns tile
// rows 64g..64g+63); thread 256 issues every copy.
template <int KS, int BN>
__global__ void __launch_bounds__(128 * WgLayout<BN>::NWG + 32, 1)
    conv_stats_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap, Params p) {
  using L = WgLayout<BN>;
  constexpr int NWG = L::NWG;
  constexpr int ZLd = L::ZLd;
  constexpr int BM = L::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full0 = base + L::bars, empty0 = full0 + 8 * L::S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::S; ++s) {
      mbar_init(full0 + 8 * s, 1);         // the producer's expect_tx; the copies' bytes
      mbar_init(empty0 + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kchunks = (p.Cin + kWBK - 1) / kWBK;
  const int n_k = KS * KS * kchunks;

  if (threadIdx.x >= 128 * NWG) {
    // ---- producer: A by TMA im2col (BM output pixels x 64 channels at the
    // tap's offset, zeros off the image, past Cin and past the batch), B by
    // two (one) tiled TMA boxes
    if (threadIdx.x != 128 * NWG) return;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int rt = tile / p.col_tiles;
      const int m0 = rt * BM, n0 = (tile - rt * p.col_tiles) * BN;
      int b, h, w;  // the tile's first row at tap (0, 0), in the image
      row_origin(p, m0, b, h, w);
      for (int tap = 0; tap < KS * KS; ++tap) {
        for (int kc = 0; kc < kchunks; ++kc, ++it) {
          const int s = it % L::S;
          mbar_wait(empty0 + 8 * s, ((it / L::S) & 1) ^ 1);
          const uint32_t a_s = base + s * L::stage_bytes, b_s = a_s + L::a_bytes;
          const uint32_t full = full0 + 8 * s;
          const int c0 = kc * kWBK;
          mbar_arrive_tx(full, L::stage_bytes);
          tma_im2col_4d(a_s, &xmap, full, c0, w, h, b, tap % KS, tap / KS);
#pragma unroll
          for (int hb = 0; hb < BN / 64; ++hb) {
            tma_load_2d(b_s + hb * kBoxBytes, &wmap, full, n0 + 64 * hb, tap * p.Cin + c0);
          }
        }
      }
    }
  } else {
    // ---- consumers
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tw = threadIdx.x & 127;
    __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(gbase + L::zs) + wg * 64 * ZLd;
    float* red = reinterpret_cast<float*>(gbase + L::red);  // [warp][stat][BN]
    __nv_bfloat16* z = static_cast<__nv_bfloat16*>(p.z);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int rt = tile / p.col_tiles;
      const int m0 = rt * BM, n0 = (tile - rt * p.col_tiles) * BN;
      for (int j = 0; j < n_k; ++j, ++it) {
        const int s = it % L::S;
        mbar_wait(full0 + 8 * s, (it / L::S) & 1);
        const uint32_t a_s = base + s * L::stage_bytes + wg * 64 * kWBK * 2;
        const uint32_t b_s = base + s * L::stage_bytes + L::a_bytes;
        // A: K-major, 128-byte rows, 8-row groups 1024 bytes apart; a k16
        // step is 32 bytes along the row. B: MN-major, 64-channel boxes 8 KB
        // apart, 8-row K groups 1024 bytes apart; a k16 step is 2 KB.
        const uint64_t da = sw128_desc(a_s, 16, 1024);
        const uint64_t db = sw128_desc(b_s, kBoxBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWBK / 16; ++kk) {
          wgmma_k16(d, da + 2 * kk, db + 128 * kk, (j > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        if (j > 0) {  // the previous stage's MMAs have retired: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % L::S));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % L::S));
      fence_acc(d);

      // epilogue. Thread (warp w, lane l) of warpgroup g holds rows
      // 64g + 16(w%4) + l/4 (+8) and channels 8j + 2(l%4) (+1), j < BN/8.
      named_bar_sync(1, 128 * NWG);  // the previous tile's readers of red and zs are done
      float v[BN / 2];  // [column pair j][e][stat]: this thread's two rows summed
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int row = 16 * (warp & 3) + (lane >> 2), col = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(zs + row * ZLd + col) =
            __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(zs + (row + 8) * ZLd + col) =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = d[4 * j + e], v1 = d[4 * j + 2 + e];
          v[(2 * j + e) * 2 + 0] = v0 + v1;
          v[(2 * j + e) * 2 + 1] = v0 * v0 + v1 * v1;
        }
      }
      fold8(v, lane);  // the warp's 16 rows
      const int vbase = ((lane >> 4) & 1) * (BN / 4) + ((lane >> 3) & 1) * (BN / 8) +
                        ((lane >> 2) & 1) * (BN / 16);
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int q = vbase + i, stat = q & 1, j = q >> 2, e = (q >> 1) & 1;
        red[(warp * 2 + stat) * BN + 8 * j + 2 * (lane & 3) + e] = v[i];
      }
      named_bar_sync(1, 128 * NWG);
      // z: this warpgroup's 64 rows x BN/8 chunks of 8 channels, 16 bytes a store
#pragma unroll
      for (int q = 0; q < BN / 16; ++q) {
        const int idx = tw + 128 * q;
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        const int m = m0 + 64 * wg + r, n = n0 + c;
        if (m < p.M && n < p.Cout) {
          *reinterpret_cast<uint4*>(z + static_cast<long long>(m) * p.Cout + n) =
              *reinterpret_cast<const uint4*>(zs + r * ZLd + c);
        }
      }
      // the tile's [sum, sum of squares]: the 4 NWG warps in order
      for (int idx = threadIdx.x; idx < 2 * BN; idx += 128 * NWG) {
        const int stat = idx / BN, n = idx % BN;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4 * NWG; ++q) s += red[(q * 2 + stat) * BN + n];
        if (n0 + n < p.Cout) p.partials[(static_cast<long long>(rt) * 2 + stat) * p.Cout + n0 + n] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32_pipelined / f32_unaligned: CUDA-core implicit GEMM on a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kFBK = 16;          // input channels per K step
constexpr int kFStages = 3;       // ring depth
constexpr int kFALd = kFBK + 4;   // A tile row stride (floats)

// BM x BN tile (128 x 128, 64 x 128, or 128 x 64 where Cout <= 64)
template <int BM, int BN>
struct F32Layout {  // float offsets into dynamic shared memory
  static constexpr int TX = BN / 8;               // threads along N
  static constexpr int threads = TX * (BM / 8);   // each an 8 x 8 patch
  static constexpr int a_floats = BM * kFALd;     // A[m][k]
  static constexpr int b_floats = kFBK * BN;      // B[k][n]
  static constexpr int stage_floats = a_floats + b_floats;
  static constexpr int red = kFStages * stage_floats;  // [threads / 32][2][BN]
  static constexpr int bytes = (red + threads / 32 * 2 * BN) * 4;
};

template <int KS, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(BM * BN / 64, 1) conv_stats_f32_kernel(Params p) {
  using L = F32Layout<BM, BN>;
  constexpr int kThreads = L::threads, TX = L::TX;
  constexpr int ACH = kFBK / 4;                // 16-byte chunks in an A row
  constexpr int APT = BM * ACH / kThreads;      // A rows a thread copies (one chunk each)
  extern __shared__ __align__(16) float fsm[];
  float* red = fsm + L::red;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  float* z = static_cast<float*>(p.z);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TX, ty = tid / TX;
  const int ac = tid % ACH, ar0 = tid / ACH;  // A: channels 4 ac.., rows ar0 + kThreads/ACH * i
  const int kchunks = (p.Cin + kFBK - 1) / kFBK;
  const int n_k = KS * KS * kchunks;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int rt = tile / p.col_tiles;
    const int m0 = rt * BM, n0 = (tile - rt * p.col_tiles) * BN;
    int rb[APT], rh[APT], rw[APT];
#pragma unroll
    for (int i = 0; i < APT; ++i) row_origin(p, m0 + ar0 + kThreads / ACH * i, rb[i], rh[i], rw[i]);

    auto load = [&](int j) {
      float* As = fsm + (j % kFStages) * L::stage_floats;
      float* Bs = As + L::a_floats;
      const int tap = j / kchunks, c0 = (j - tap * kchunks) * kFBK;
      const int ci = c0 + 4 * ac;
#pragma unroll
      for (int i = 0; i < APT; ++i) {
        const long long off = tap_offset(p, rb[i], rh[i], rw[i], tap / KS, tap % KS);
        const uint32_t dst = smem_u32(As + (ar0 + kThreads / ACH * i) * kFALd + 4 * ac);
        if (VEC) {  // Cin % 4 == 0: the 4 channels are all in or all out
          const bool ok = off >= 0 && ci < p.Cin;
          cp_async16(dst, ok ? x + off + ci : x, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = off >= 0 && ci + q < p.Cin;
            cp_async4(dst + 4 * q, ok ? x + off + ci + q : x, ok);
          }
        }
      }
      const float* wrow = w + static_cast<long long>(tap) * p.Cin * p.Cout;
      if (VEC) {
#pragma unroll
        for (int e = 0; e < kFBK * BN / 4 / kThreads; ++e) {
          const int idx = tid + kThreads * e;
          const int k = idx / (BN / 4), nn = (idx % (BN / 4)) * 4;
          const int cw = c0 + k, col = n0 + nn;
          const bool ok = cw < p.Cin && col < p.Cout;
          cp_async16(smem_u32(Bs + k * BN + nn),
                     ok ? wrow + static_cast<long long>(cw) * p.Cout + col : w, ok);
        }
      } else {
#pragma unroll 4
        for (int e = 0; e < kFBK * BN / kThreads; ++e) {
          const int idx = tid + kThreads * e;
          const int k = idx / BN, nn = idx % BN;
          const int cw = c0 + k, col = n0 + nn;
          const bool ok = cw < p.Cin && col < p.Cout;
          cp_async4(smem_u32(Bs + k * BN + nn),
                    ok ? wrow + static_cast<long long>(cw) * p.Cout + col : w, ok);
        }
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int s = 0; s < kFStages - 1; ++s) {
      if (s < n_k) load(s);
      cp_async_commit();
    }
    for (int j = 0; j < n_k; ++j) {
      cp_async_wait<kFStages - 2>();  // stage j has landed (this thread's copies)
      __syncthreads();                // ... everyone's, and stage j - 1 is free
      if (j + kFStages - 1 < n_k) load(j + kFStages - 1);
      cp_async_commit();
      const float* As = fsm + (j % kFStages) * L::stage_floats;
      const float* Bs = As + L::a_floats;
#pragma unroll
      for (int kq = 0; kq < kFBK; kq += 4) {
        float4 a[8];  // rows ty*4 + i and BM/2 + ty*4 + i, channels kq..kq+3
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(As + (ty * 4 + i) * kFALd + kq);
          a[4 + i] = *reinterpret_cast<const float4*>(As + (BM / 2 + ty * 4 + i) * kFALd + kq);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * BN + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kq + kk) * BN + BN / 2 + tx * 4);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(ai, b[jj], acc[i][jj]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the ring before the next tile's loads

    // epilogue: rows ty*4 + i and BM/2 + ty*4 + i, channels tx*4 + j and BN/2 + tx*4 + j
    float s1[8], s2[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s1[jj] = s2[jj] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s1[jj] += acc[i][jj];
        s2[jj] += acc[i][jj] * acc[i][jj];
      }
      if (m >= p.M) continue;
      float* zrow = z + static_cast<long long>(m) * p.Cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + BN / 2 * h + tx * 4;
        if (VEC) {
          if (col < p.Cout) {
            *reinterpret_cast<float4*>(zrow + col) = make_float4(
                acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (col + q < p.Cout) zrow[col + q] = acc[i][4 * h + q];
          }
        }
      }
    }
    // lanes l, l ^ TX, ... hold the same channels (the warp's rows of ty)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int o = TX; o < 32; o <<= 1) {
        s1[jj] += __shfl_xor_sync(0xffffffffu, s1[jj], o);
        s2[jj] += __shfl_xor_sync(0xffffffffu, s2[jj], o);
      }
    }
    if (lane < TX) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = (jj < 4 ? 0 : BN / 2) + tx * 4 + (jj & 3);
        red[(warp * 2 + 0) * BN + n] = s1[jj];
        red[(warp * 2 + 1) * BN + n] = s2[jj];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < 2 * BN; idx += kThreads) {
      const int stat = idx / BN, n = idx % BN;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kThreads / 32; ++q) s += red[(q * 2 + stat) * BN + n];
      if (n0 + n < p.Cout) p.partials[(static_cast<long long>(rt) * 2 + stat) * p.Cout + n0 + n] = s;
    }
    // the next tile writes red only after its K loop's barriers
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver entry point, reached through the runtime (no -lcuda).
void* driver_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &ptr, 12000, cudaEnableDefault, &q);
#else
  cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &q);
#endif
  return q == cudaDriverEntryPointSuccess ? ptr : nullptr;
}

EncodeTiled encode_tiled() {
  static EncodeTiled fn = reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

EncodeIm2col encode_im2col() {
  static EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// w as a [KS*KS*Cin, Cout] bf16 matrix in 64 x 64 boxes, 128-byte swizzle,
// zeros outside it.
cudaError_t weight_map(CUtensorMap* map, const void* w, int k_rows, int cout) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(k_rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cout) * 2};
  const cuuint32_t box[2] = {64, kWBK};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                            strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// x [B,H,W,Cin] bf16 as the conv's im2col: each load walks `bm` output
// pixels (W fastest, then H, then the batch) over the input positions
// -pad_lo, -pad_lo + s, ... up to dim - 1 + pad_hi - (KS - 1), and reads 64
// channels at each, shifted by the tap; 128-byte swizzle, zeros outside x.
cudaError_t input_map(CUtensorMap* map, const Params& p, int ks, int bm) {
  EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int pad_hi = ks == 1 ? 0 : 1;  // SAME 3x3: (1, 1) at stride 1, (0, 1) at stride 2
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.Cin), static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t row = static_cast<cuuint64_t>(p.Cin) * 2;
  const cuuint64_t strides[3] = {row, row * p.W, row * p.W * p.H};
  const int lower[2] = {-p.pad, -p.pad};
  const int upper[2] = {pad_hi - (ks - 1), pad_hi - (ks - 1)};
  const cuuint32_t estrides[4] = {1, static_cast<cuuint32_t>(p.sw), static_cast<cuuint32_t>(p.sh), 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p.x), dims,
                            strides, lower, upper, kWBK, bm, estrides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared memory limit, once per process.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int KS, int BN>
cudaError_t launch_wgmma(const Params& p, int grid, cudaStream_t s) {
  using L = WgLayout<BN>;
  static bool smem_set = false;
  auto kernel = conv_stats_wgmma_kernel<KS, BN>;
  cudaError_t err = allow_smem(kernel, L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  err = input_map(&xmap, p, KS, L::BM);
  if (err != cudaSuccess) return err;
  err = weight_map(&wmap, p.w, KS * KS * p.Cin, p.Cout);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128 * L::NWG + 32, L::bytes, s>>>(xmap, wmap, p);
  return cudaGetLastError();
}

template <int KS, int BM, int BN, bool VEC>
cudaError_t launch_f32(const Params& p, int grid, cudaStream_t s) {
  using L = F32Layout<BM, BN>;
  static bool smem_set = false;
  auto kernel = conv_stats_f32_kernel<KS, BM, BN, VEC>;
  const cudaError_t err = allow_smem(kernel, L::bytes, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, L::threads, L::bytes, s>>>(p);
  return cudaGetLastError();
}

// The compiled tile configurations: (variant, BM, BN, stages).
bool compiled(int variant, int bm, int bn, int stages) {
  switch (variant) {
    case kBf16Wgmma:
      return bm == WgLayout<128>::BM && (bn == 128 || bn == 64) && stages == kStages;
    case kBf16Unaligned: return bm == kUBM && bn == kUBN && stages == 1;
    case kF32Pipelined:
    case kF32Unaligned:
      return ((bm == 128 && bn == 128) || (bm == 64 && bn == 128) || (bm == 128 && bn == 64)) &&
             stages == kFStages;
    default: return false;
  }
}

int smem_bytes(int variant, int bm, int bn) {
  switch (variant) {
    case kBf16Wgmma: return bn == 128 ? WgLayout<128>::bytes : WgLayout<64>::bytes;
    case kBf16Unaligned: return kUSmemBytes;
    default:
      return bn == 64 ? F32Layout<128, 64>::bytes
                      : (bm == 128 ? F32Layout<128, 128>::bytes : F32Layout<64, 128>::bytes);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <int KS, bool VEC>
cudaError_t dispatch_f32(const Params& p, int bm, int bn, int grid, cudaStream_t s) {
  if (bn == 64) return launch_f32<KS, 128, 64, VEC>(p, grid, s);
  return bm == 128 ? launch_f32<KS, 128, 128, VEC>(p, grid, s)
                   : launch_f32<KS, 64, 128, VEC>(p, grid, s);
}

// Launches the variant at a compiled configuration (compiled() holds).
template <int KS>
cudaError_t dispatch(int variant, const Params& p, int bm, int bn, int grid, cudaStream_t s) {
  switch (variant) {
    case kBf16Wgmma:
      return bn == 128 ? launch_wgmma<KS, 128>(p, grid, s) : launch_wgmma<KS, 64>(p, grid, s);
    case kBf16Unaligned:
      conv_stats_bf16_unaligned_kernel<<<grid, kUThreads, 0, s>>>(p, KS);
      return cudaGetLastError();
    case kF32Pipelined: return dispatch_f32<KS, true>(p, bm, bn, grid, s);
    default: return dispatch_f32<KS, false>(p, bm, bn, grid, s);
  }
}

template <typename K>
cudaError_t occupancy_of(K kernel, int threads, int smem, int* blocks) {
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <int KS, bool VEC>
cudaError_t occupancy_f32(int bm, int bn, int smem, int* blocks) {
  if (bn == 64) return occupancy_of(conv_stats_f32_kernel<KS, 128, 64, VEC>, 128, smem, blocks);
  return bm == 128 ? occupancy_of(conv_stats_f32_kernel<KS, 128, 128, VEC>, 256, smem, blocks)
                   : occupancy_of(conv_stats_f32_kernel<KS, 64, 128, VEC>, 128, smem, blocks);
}

template <int KS>
cudaError_t occupancy(int variant, int bm, int bn, int* blocks) {
  const int smem = smem_bytes(variant, bm, bn);
  switch (variant) {
    case kBf16Wgmma:
      return bn == 128 ? occupancy_of(conv_stats_wgmma_kernel<KS, 128>, 288, smem, blocks)
                       : occupancy_of(conv_stats_wgmma_kernel<KS, 64>, 288, smem, blocks);
    case kBf16Unaligned:
      return occupancy_of(conv_stats_bf16_unaligned_kernel, kUThreads, 0, blocks);
    case kF32Pipelined: return occupancy_f32<KS, true>(bm, bn, smem, blocks);
    default: return occupancy_f32<KS, false>(bm, bn, smem, blocks);
  }
}

}  // namespace

// One conv-statistics call. x [B,H,W,Cin] NHWC and w [ks,ks,Cin,Cout] HWIO,
// contiguous, bf16 for variants 0-1 and f32 for 2-3; z [B,Ho,Wo,Cout]
// contiguous in that dtype; partials [ceil(B*Ho*Wo / bm), 2, Cout] f32
// scratch; stats [2, Cout] f32. (bm, bn, stages, grid) is the plan from
// ops/conv_stats.py: it must name a compiled configuration, the variant's
// alignment rules must hold, and 1 <= grid <= the number of output tiles.
// Returns the first cudaError_t met (0 on success); nothing is launched on
// a refusal.
extern "C" int conv_stats_launch(int variant, int ks, const void* x, const void* w, void* z,
                                 void* partials, void* stats, int B, int H, int W, int Cin,
                                 int Cout, int sh, int sw, int bm, int bn, int stages, int grid,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || sh < 1 || sw < 1) return inval;
  if ((ks != 1 && ks != 3) || !compiled(variant, bm, bn, stages)) return inval;
  int pad, Ho, Wo;
  if (ks == 1) {
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
    return inval;
  }
  if (variant == kBf16Wgmma &&
      (Cin % 8 != 0 || Cout % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(z))) {
    return inval;
  }
  if (variant == kF32Pipelined &&
      (Cin % 4 != 0 || Cout % 4 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(z))) {
    return inval;
  }
  const long long m_ll = static_cast<long long>(B) * Ho * Wo;
  if (m_ll > 0x7fffffffLL - bm || static_cast<long long>(B) * H * W * Cin > (1LL << 40) ||
      static_cast<long long>(ks) * ks * Cin * Cout > 0x7fffffffLL) {
    return inval;
  }
  const int M = static_cast<int>(m_ll);
  const int row_tiles = (M + bm - 1) / bm, col_tiles = (Cout + bn - 1) / bn;
  const long long tiles = static_cast<long long>(row_tiles) * col_tiles;
  if (tiles > 0x7fffffffLL || grid < 1 || grid > tiles) return inval;
  Params p{x,  w,  z,   static_cast<float*>(partials), B, H, W, Cin, Ho, Wo, Cout, sh, sw,
           pad, M, col_tiles, static_cast<int>(tiles)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ks == 1 ? dispatch<1>(variant, p, bm, bn, grid, s) : dispatch<3>(variant, p, bm, bn, grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid((Cout + 31) / 32, 2);
  reduce_partials_kernel<<<rgrid, 32 * kRedWarps, 0, s>>>(static_cast<const float*>(partials),
                                              static_cast<float*>(stats), row_tiles, Cout);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory (bytes) a block of the configuration takes, as plan() counts it.
extern "C" int conv_stats_smem_bytes(int variant, int bm, int bn) {
  return compiled(variant, bm, bn, variant == kBf16Wgmma ? kStages
                                   : variant == kBf16Unaligned ? 1 : kFStages)
             ? smem_bytes(variant, bm, bn)
             : -1;
}

// Blocks of the configuration that fit on one SM of `device` (registers,
// shared memory, threads), into *blocks.
extern "C" int conv_stats_occupancy(int variant, int ks, int bm, int bn, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stages = variant == kBf16Wgmma ? kStages : variant == kBf16Unaligned ? 1 : kFStages;
  if ((ks != 1 && ks != 3) || !compiled(variant, bm, bn, stages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = ks == 1 ? occupancy<1>(variant, bm, bn, blocks) : occupancy<3>(variant, bm, bn, blocks);
  return static_cast<int>(err);
}

extern "C" const char* conv_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

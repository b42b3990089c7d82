// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _attn_kernel of
// deeplearning4j_tpu/ops/attention_pallas.py:175 (driven by _run_fwd :249,
// pallas_call :279).
//
// Contract (attention_pallas._attn_kernel), per (batch b, head h, query row r):
//   s[c]   = (q[r] . k[c]) * scale                     f32 accumulation
//   valid  = c < T  and  mask[b, c] > 0  and  (not causal or c <= r)
//   s[c]   = valid ? s[c] : -1e30
//   online softmax over key tiles, f32 running max m and sum l:
//     m'   = max(m, max_c s[c]);  p[c] = valid ? exp(s[c] - m') : 0
//     l    = l * exp(m - m') + sum_c p[c]
//     acc  = acc * exp(m - m') + round(p) . v        round() = to v's dtype
//   out[r] = acc / max(l, 1e-30)                       in q's dtype
//   lse[r] = m + log(max(l, 1e-30))                    f32
// A fully masked row has l = 0, so it emits 0 and lse = -1e30 (the sentinel
// the backward relies on). mask is a [B, T] f32 key mask shared by the
// heads, or null. q, k, v are [B, T, H, D] read through element strides
// (batch, time, head; the feature axis contiguous), so the views of one
// [B, T, 3, H, D] projection are read in place; out is [B, T, H, D]
// contiguous in q's dtype, lse [B, H, T] f32. D <= 128, any T.
//
// What bounds it on an H100 SXM: at the training path's shape (B=4, H=8,
// T=4096, D=64, causal) the two products take 4*B*H*D*T(T+1)/2 = 68.7 GFLOP
// against ~34 MB moved in f32, so it is bound by operations: 1.03 ms at the
// CUDA cores' 67 TFLOP/s f32 rate, 0.07 ms on the bf16 tensor cores (989
// TFLOP/s). The f32 contract holds out to 1e-5, which one-pass TF32 (about
// three decimal digits) cannot; a 3xTF32 split can, at 3 x 68.7 GFLOP over
// 495 TFLOP/s = 0.42 ms, under the CUDA-core bound.
//
// Design. One block owns a query tile of one (b, h) and loops over key
// tiles of 64, so the running max, sum and output stay in registers for the
// whole sweep (the TPU's sequential key grid axis with VMEM scratch). Query
// tiles run longest first (the block index counts down the rows), since
// under causal masking tile i does i + 1 key tiles and is skipped past the
// diagonal. ops/attention.py plan() names the variant and the feature width
// DP (64, or 128 where D > 64; zeros fill the tail) from the
// shape, strides, dtype and alignment; flash_attn_launch checks the choice.
//
// Every f32 variant runs on the tensor cores with each operand split as
// x = hi + lo, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each
// product taken as lo.hi + hi.lo + hi.hi (the dropped lo.lo term is ~2^-22
// relative); one-pass TF32 is never used on f32 inputs. The tensor cores do
// not round their f32 sums to nearest, so a long chain of products into one
// accumulator drifts past 1e-5: each 16 features of S and each tile's P.V
// start from zero and are added to the running sums on the CUDA cores. The
// online softmax runs on the accumulator fragments (mma.sync's and wgmma's
// layouts agree): a row lives on a quad of lanes (shuffles xor 1, 2), exp
// comes from the SFU, and a tile whose keys are all valid for the warp's
// rows (no mask, inside T, below the causal diagonal: most tiles) skips the
// masking tests. P feeds the P.V product from registers with the keys of
// each 8-key step taken in the order (0, 2, 4, 6, 1, 3, 5, 7): then the
// accumulator fragment of S is the TF32 A fragment, lane for lane.
//
// f32_3xtf32_wgmma (the training path: D <= 64, 16-byte aligned q, k, v,
// strides and D multiples of 4): 128 query rows a block, two warpgroups of
// 64. All 256 threads land each 64-key K and V tile by cp.async
// (double-buffered, rows padded to 68 floats) and split it into TF32 halves
// stored K-major in 128-byte swizzled boxes: K as it is, V transposed (TF32
// wgmma reads only K-major operands) with its keys in P's order. Q is split
// once the same way. S = Q.K^T runs on wgmma m64n64k8 from shared memory,
// 24 products a tile in four fresh accumulators; O += P.V on wgmma m64n64k8
// with P's halves in registers. A warpgroup skips a causal tile wholly above
// its rows.
// f32_3xtf32 (64 < D <= 128, aligned): the split on mma.sync m16n8k8, warps
// of 16 query rows, 4 a block at DP = 128, each splitting the K and V
// fragments it reads (a split tile would not fit); V's B fragment reads rows
// 2t, 2t + 1. f32_3xtf32_unaligned: the same body with 4-byte copies, 8
// warps at DP = 64 sharing each tile split once in shared memory.
//
// bf16_wgmma (16-byte aligned q, k, v and strides): 128 query rows a block,
// two consumer warpgroups of 64 rows and one producer warp. The producer
// loads Q once and fills a ring of K and V tiles (64 keys x 64 features a
// box; 8 stages at DP = 64, 5 at 128) by TMA through 4-D tensor maps over
// (D, H, T, B) with the views' strides, 128-byte swizzle, zeros past T and
// D. S = Q.K^T runs on wgmma m64n64k16 from shared memory (K is K-major),
// the softmax in registers, P is rounded to bf16 register fragments (the
// accumulator layout of S is wgmma's A-register layout) and O += P.V runs
// on wgmma m64nDPk16 with A from registers and V read MN-major through the
// transpose bit. A warpgroup skips a causal key tile wholly above its rows.
// bf16_unaligned: the mma.sync body on bf16 inputs widened in shared
// memory, in one TF32 pass, which is exact for bf16 operands (8 significant
// bits fit TF32's 11), so it keeps the bf16 contract.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Variant {
  kF32Tf32x3 = 0,
  kF32Tf32x3Unaligned = 1,
  kBf16Wgmma = 2,
  kBf16Unaligned = 3,
  kF32Tf32x3Wgmma = 4
};

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* out;
  float* lse;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int B, H, T, D, causal;
  float scale;
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

// one (64 features x 1 head x rows x 1 batch) box of a [B,T,H,D] map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }

// TF32 of x, rounded to nearest (ties away), as the tensor cores read it
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo in TF32: hi the top 11 significant bits, lo the next 11
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], TF32 operands, f32 accumulators. Not
// volatile: a pure function of its operands, so the compiler may interleave
// independent MMAs (volatile asm keeps program order, and each MMA would
// wait out the latency of the one before).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// the online softmax and the epilogue, shared by both bodies
// ---------------------------------------------------------------------------

// One key tile's update of a thread's two rows (row[0] and row[1] = row[0]
// + 8) on the accumulator fragments s (mma.sync's and wgmma's layout: n-tile
// j, element e is row e >> 1, key key0 + 8j + (e & 1), key0 = k0 + 2 (lane %
// 4)). keyok bit 2j + c: key key0 + 8j + c lies inside T and the mask. On
// return s holds p (0 where invalid), m and l are updated and alpha holds
// each row's rescale factor exp(m - m'). exp comes from the SFU (__expf:
// ex2.approx of x log2(e), within a few ulp where p matters, so the f32
// output stays within 1e-5 of the f32 reference). CHECK = false: every key
// of the tile is valid for every row (keyok and causal are not read).
template <int NT, bool CHECK = true>
__device__ __forceinline__ void softmax_tile(float (&s)[NT * 4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale, uint32_t keyok,
                                             int key0, const int (&row)[2], int causal) {
  uint32_t ok = 0;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = e & 1;
      const bool valid = !CHECK || (((keyok >> (2 * j + c)) & 1u) &&
                                    (!causal || key0 + 8 * j + c <= row[r]));
      const float x = valid ? s[4 * j + e] * scale : kNegInf;
      s[4 * j + e] = x;
      ok |= static_cast<uint32_t>(valid) << (4 * j + e);
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m[r], mx[r]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      // explicit zero: on a row with nothing valid yet m' == s == -1e30
      const float x = s[4 * j + e] - m_new[r];
      const float pv = ((ok >> (4 * j + e)) & 1u) ? __expf(x) : 0.f;
      s[4 * j + e] = pv;
      sum[r] += pv;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    alpha[r] = __expf(m[r] - m_new[r]);
    l[r] = l[r] * alpha[r] + sum[r];
    m[r] = m_new[r];
  }
}

// Whether every key of the tile [k0, k0 + keys) is valid for a warp whose
// first query row is `row0`: inside T, no mask, and under causal masking
// not after that row.
__device__ __forceinline__ bool full_tile(const float* mask, int k0, int keys, int T_len,
                                          int causal, int row0) {
  return mask == nullptr && k0 + keys <= T_len && (!causal || k0 + keys - 1 <= row0);
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void store_out(float* out, float x) { *out = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16(x);
}

// out and lse of a thread's two rows from the output fragments o (n-tile j:
// features 8j + 2 (lane % 4) + c, element 2r + c).
template <typename T, int NO>
__device__ __forceinline__ void write_rows(const Params& p, const float (&o)[NO],
                                           const float (&m)[2], const float (&l)[2],
                                           const int (&row)[2], int b, int h, int t4) {
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.T) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    const long long base = ((static_cast<long long>(b) * p.T + row[r]) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * t4 + c;
        if (d < p.D) store_out(out + base + d, o[4 * j + 2 * r + c] / l_safe);
      }
    }
    if (t4 == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row[r]] = m[r] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// f32_3xtf32 / f32_3xtf32_unaligned / bf16_unaligned: mma.sync TF32
// ---------------------------------------------------------------------------

constexpr int kMKeys = 64;  // keys per tile

// DP = 64: 8 warps of 16 query rows, and each K and V tile split into its
// TF32 halves once, in shared memory, for all of them. DP = 128: 4 warps,
// each splitting the K and V fragments it reads (the halves would not fit).
template <int DP>
struct MmaLayout {  // float offsets into dynamic shared memory
  static constexpr bool PRESPLIT = DP == 64;
  static constexpr int WARPS = PRESPLIT ? 8 : 4;
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = DP + 4;  // row stride: fragment reads hit 32 distinct banks
  static constexpr int tile = kMKeys * LD;
  static constexpr int q_hi = 0;
  static constexpr int q_lo = ROWS * LD;
  static constexpr int kv = 2 * ROWS * LD;             // [stage][K tile, V tile]
  static constexpr int kv_lo = kv + 2 * 2 * tile;      // [K, V] low halves of the current tile
  static constexpr int valid = kv_lo + (PRESPLIT ? 2 * tile : 0);  // [stage][kMKeys]
  static constexpr int bytes = (valid + 2 * kMKeys) * 4;
};

// ROWS rows r0.. of src (row stride st elements) into dst[ROWS][DP + 4] as
// f32; zeros past T and past D.
template <typename T, int DP, bool VEC, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long st, int r0,
                                          int T_len, int D, int tid) {
  constexpr int LD = DP + 4;
  if constexpr (VEC) {  // f32, 16-byte copies: D % 4 == 0, so a chunk is all in or all out
    constexpr int CH = DP / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i - r * CH) * 4, t = r0 + r;
      const bool ok = t < T_len && c < D;
      cp_async16(smem_u32(dst + r * LD + c), ok ? src + t * st + c : src, ok);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP, t = r0 + r;
      const bool ok = t < T_len && c < D;
      cp_async4(smem_u32(dst + r * LD + c), ok ? src + t * st + c : src, ok);
    }
  } else {  // bf16, widened (exact) as it is stored
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP, t = r0 + r;
      dst[r * LD + c] = (t < T_len && c < D) ? __bfloat162float(src[t * st + c]) : 0.f;
    }
  }
}

// c[16 x 8] = a . b, starting from zero
__device__ __forceinline__ void mma_tf32_first(float* c, const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The B fragment pair (x0, x1) of K or V as TF32 halves: read split from
// shared memory (lo at `lo_off` floats past hi), or split here.
template <bool PRE>
__device__ __forceinline__ void frag(const float* x, int lo_off, int second, uint32_t (&hi)[2],
                                     uint32_t (&lo)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* at = x + e * second;
    if constexpr (PRE) {
      hi[e] = f2u(at[0]);
      lo[e] = f2u(at[lo_off]);
    } else {
      split(at[0], hi[e], lo[e]);
    }
  }
}

// A tile's products accumulate in fresh registers (QK: per pair of 8-feature
// steps; PV: per tile) that are then added to the running sums in f32 on the
// CUDA cores: the tensor cores' accumulation is not rounded to nearest, and
// a 24-deep chain into one accumulator drifts past 1e-5.
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(MmaLayout<DP>::THREADS, 1) flash_mma_kernel(Params p) {
  using L = MmaLayout<DP>;
  constexpr int LD = L::LD, NT = L::THREADS;
  constexpr bool kF32 = std::is_same<T, float>::value;  // 3 passes; bf16 is exact in one
  constexpr bool kPre = kF32 && L::PRESPLIT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int T_len = p.T, D = p.D;
  const int n_qt = (T_len + L::ROWS - 1) / L::ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * L::ROWS;  // longest first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;

  int n_kt = (T_len + kMKeys - 1) / kMKeys;
  if (p.causal) n_kt = min(n_kt, (min(q0 + L::ROWS, T_len) - 1) / kMKeys + 1);

  auto load_kv = [&](int kt) {
    const int st = kt & 1, k0 = kt * kMKeys;
    float* ks = sm + L::kv + st * 2 * L::tile;
    load_rows<T, DP, VEC, kMKeys, NT>(ks, k, p.k_st, k0, T_len, D, tid);
    load_rows<T, DP, VEC, kMKeys, NT>(ks + L::tile, v, p.v_st, k0, T_len, D, tid);
    if (tid < kMKeys) {
      const int t = k0 + tid;
      sm[L::valid + st * kMKeys + tid] =
          (t < T_len && (mask == nullptr || mask[t] > 0.f)) ? 1.f : 0.f;
    }
  };
  load_rows<T, DP, VEC, L::ROWS, NT>(sm + L::q_hi, q, p.q_st, q0, T_len, D, tid);
  load_kv(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kF32) {  // split q once: hi in place, lo beside it
    for (int i = tid; i < L::ROWS * LD; i += NT) {
      uint32_t hi, lo;
      split(sm[L::q_hi + i], hi, lo);
      sm[L::q_hi + i] = __uint_as_float(hi);
      sm[L::q_lo + i] = __uint_as_float(lo);
    }
  }

  constexpr int NO = DP / 2;  // output fragments: DP / 8 n-tiles x 4
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float* qh = sm + L::q_hi + (16 * warp + g) * LD + t4;
  const float* ql = sm + L::q_lo + (16 * warp + g) * LD + t4;
  constexpr int kLoOff = L::kv_lo - L::kv;  // K's lo from K's hi (stage 0; see below)

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();  // (possibly empty: keeps the group count uniform)
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt = 0, the split q) is visible to all
    const int st = kt & 1, k0 = kt * kMKeys;
    float* ks = sm + L::kv + st * 2 * L::tile;
    const float* vs = ks + L::tile;
    const float* kok = sm + L::valid + st * kMKeys;
    // lo halves live at kv_lo for either stage: their offset from this stage's hi
    const int lo_off = kLoOff - st * 2 * L::tile;
    if constexpr (kPre) {  // split the tile once for all warps: hi in place, lo beside
      for (int i = tid; i < 2 * L::tile; i += NT) {
        uint32_t hi, lo;
        split(ks[i], hi, lo);
        ks[i] = __uint_as_float(hi);
        ks[lo_off + i] = __uint_as_float(lo);
      }
      __syncthreads();
    }

    // S = Q.K^T: 16 rows x 64 keys a warp, 16 features at a time into fresh
    // accumulators
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < DP / 8; kc += 2) {
      float part[32];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 8 * (kc + half);
        const uint32_t ah[4] = {f2u(qh[c]), f2u(qh[8 * LD + c]), f2u(qh[c + 4]),
                                f2u(qh[8 * LD + c + 4])};
        uint32_t al[4];
        if constexpr (kF32) {
          al[0] = f2u(ql[c]);
          al[1] = f2u(ql[8 * LD + c]);
          al[2] = f2u(ql[c + 4]);
          al[3] = f2u(ql[8 * LD + c + 4]);
        }
        // the K fragments of the 8 key tiles, then each pass over all 8:
        // consecutive MMAs are independent
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kr = ks + (8 * j + g) * LD + c + t4;
          if constexpr (kF32) {
            frag<kPre>(kr, lo_off, 4, bh[j], bl[j]);
          } else {
            bh[j][0] = f2u(kr[0]);
            bh[j][1] = f2u(kr[4]);
          }
        }
        if constexpr (kF32) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (half == 0) {
              mma_tf32_first(part + 4 * j, al, bh[j][0], bh[j][1]);
            } else {
              mma_tf32(part + 4 * j, al, bh[j][0], bh[j][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_tf32(part + 4 * j, ah, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_tf32(part + 4 * j, ah, bh[j][0], bh[j][1]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (half == 0) {
              mma_tf32_first(part + 4 * j, ah, bh[j][0], bh[j][1]);
            } else {
              mma_tf32(part + 4 * j, ah, bh[j][0], bh[j][1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += part[i];
    }

    float alpha[2];
    if (full_tile(mask, k0, kMKeys, T_len, p.causal, q0 + 16 * warp)) {
      softmax_tile<8, false>(s, m, l, alpha, p.scale, 0u, k0 + 2 * t4, row, 0);
    } else {
      uint32_t keyok = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          keyok |= static_cast<uint32_t>(kok[8 * j + 2 * t4 + c] > 0.f) << (2 * j + c);
        }
      }
      softmax_tile<8>(s, m, l, alpha, p.scale, keyok, k0 + 2 * t4, row, p.causal);
    }

    // P as TF32 halves (hi in s, lo in pl); in bf16, p in v's dtype, exact
    float pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (kF32) {
        uint32_t hi, lo;
        split(s[i], hi, lo);
        s[i] = __uint_as_float(hi);
        pl[i] = __uint_as_float(lo);
      } else {
        s[i] = round_bf16(s[i]);
      }
    }
    // O = alpha O + P.V, the keys of each 8-key step in the order (0, 2, 4,
    // 6, 1, 3, 5, 7): the S fragment is then the A fragment as it stands.
    // The tile's P.V gathers in fresh registers, 8 feature tiles in flight.
    float part[NO];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t ah[4] = {f2u(s[4 * kk]), f2u(s[4 * kk + 2]), f2u(s[4 * kk + 1]),
                              f2u(s[4 * kk + 3])};
      uint32_t al[4];
      if constexpr (kF32) {
        al[0] = f2u(pl[4 * kk]);
        al[1] = f2u(pl[4 * kk + 2]);
        al[2] = f2u(pl[4 * kk + 1]);
        al[3] = f2u(pl[4 * kk + 3]);
      }
      const float* vr = vs + (8 * kk + 2 * t4) * LD + g;
      uint32_t bh[DP / 8][2], bl[DP / 8][2];
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        if constexpr (kF32) {
          frag<kPre>(vr + 8 * dn, lo_off, LD, bh[dn], bl[dn]);
        } else {
          bh[dn][0] = f2u(vr[8 * dn]);
          bh[dn][1] = f2u(vr[8 * dn + LD]);
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          if (kk == 0) {
            mma_tf32_first(part + 4 * dn, al, bh[dn][0], bh[dn][1]);
          } else {
            mma_tf32(part + 4 * dn, al, bh[dn][0], bh[dn][1]);
          }
        }
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) mma_tf32(part + 4 * dn, ah, bl[dn][0], bl[dn][1]);
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) mma_tf32(part + 4 * dn, ah, bh[dn][0], bh[dn][1]);
      } else {
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          if (kk == 0) {
            mma_tf32_first(part + 4 * dn, ah, bh[dn][0], bh[dn][1]);
          } else {
            mma_tf32(part + 4 * dn, ah, bh[dn][0], bh[dn][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], part[i]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  write_rows<T>(p, o, m, l, row, b, h, t4);
}

// ---------------------------------------------------------------------------
// bf16_wgmma: TMA ring, wgmma products, softmax in registers
// ---------------------------------------------------------------------------

constexpr int kWRows = 128;          // query rows per block: two consumer warpgroups
constexpr int kWKeys = 64;           // keys per tile
constexpr int kWThreads = 128 * 2 + 32;

template <int DP>
struct WgLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int NB = DP / 64;                    // 64-feature boxes (128-byte rows)
  static constexpr int S = DP == 64 ? 8 : 5;            // K/V ring depth: TMA latency in flight
  static constexpr uint32_t box_q = kWRows * 128;       // 128 rows x 64 bf16
  static constexpr uint32_t box_kv = kWKeys * 128;      // 64 keys x 64 bf16
  static constexpr uint32_t q = 0;                      // [NB] Q boxes
  static constexpr uint32_t ring = NB * box_q;          // [stage][NB K boxes, NB V boxes]
  static constexpr uint32_t stage_bytes = 2 * NB * box_kv;
  static constexpr uint32_t bars = ring + S * stage_bytes;  // q, full[S], empty[S]
  static constexpr uint32_t bytes = bars + (1 + 2 * S) * 8 + 1024;  // + alignment slack
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

// d[64 x 64] (+)= A[64 x 16] (K-major, shared) * B[16 x 64] (K-major, shared)
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] (bf16 registers) * B[16 x 64] (MN-major, shared: tnspB = 1)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d[64 x 128] += A[64 x 16] (bf16 registers) * B[16 x 128] (MN-major, shared: tnspB = 1)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64k16(d, a, db, 1);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128k16(d, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Threads [0, 256) are the two consumer warpgroups (warpgroup w owns query
// rows q0 + 64w ..); thread 256 issues every copy.
template <int DP>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, Params p) {
  using L = WgLayout<DP>;
  constexpr int NB = L::NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  const uint32_t qbar = base + L::bars, full0 = qbar + 8, empty0 = full0 + 8 * L::S;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < L::S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx; the copies' bytes
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int T_len = p.T;
  const int n_qt = (T_len + kWRows - 1) / kWRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kWRows;  // longest first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  int n_kt = (T_len + kWKeys - 1) / kWKeys;
  if (p.causal) n_kt = min(n_kt, (min(q0 + kWRows, T_len) - 1) / kWKeys + 1);

  if (threadIdx.x >= 256) {
    // ---- producer: Q once, then K and V tiles through the ring
    if (threadIdx.x != 256) return;
    mbar_arrive_tx(qbar, NB * L::box_q);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      tma_load_4d(base + L::q + i * L::box_q, &qmap, qbar, 64 * i, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % L::S;
      mbar_wait(empty0 + 8 * s, ((kt / L::S) & 1) ^ 1);
      const uint32_t st = base + L::ring + s * L::stage_bytes, full = full0 + 8 * s;
      mbar_arrive_tx(full, L::stage_bytes);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        tma_load_4d(st + i * L::box_kv, &kmap, full, 64 * i, h, kt * kWKeys, b);
        tma_load_4d(st + (NB + i) * L::box_kv, &vmap, full, 64 * i, h, kt * kWKeys, b);
      }
    }
  } else {
    // ---- consumers
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t4 = lane & 3;
    const int row[2] = {q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2),
                        q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8};
    const int wg_last = q0 + 64 * wg + 63;
    const float* mask =
        p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
    constexpr int NO = DP / 2;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t qa = base + L::q + wg * 64 * 128;  // this warpgroup's 64 rows of each box
    mbar_wait(qbar, 0);
    // S for key tile kt: A and B both K-major (128-byte rows, 8-row groups
    // 1024 bytes apart); a k16 step is 32 bytes along the row
    auto issue_s = [&](float (&acc)[32], int kt) {
      const uint32_t ks = base + L::ring + (kt % L::S) * L::stage_bytes;
      mbar_wait(full0 + 8 * (kt % L::S), (kt / L::S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss_m64n64k16(acc, sw128_desc(qa + (kk >> 2) * L::box_q + off, 16, 1024),
                           sw128_desc(ks + (kk >> 2) * L::box_kv + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // key tiles wholly above this warpgroup's rows add nothing: it only
    // passes them on
    const int n_wg = p.causal ? min(n_kt, wg_last / kWKeys + 1) : n_kt;
    float sc[32], sn[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = sn[i] = 0.f;
    if (n_wg > 0) {
      issue_s(sc, 0);
      wgmma_wait<0>();
      fence_acc(sc);
    }
    // One tile a turn: S of the next tile runs on the tensor cores while
    // this tile's softmax runs, and this tile's P.V while the next turn's
    // softmax runs; O is rescaled only once the previous P.V has landed.
    for (int kt = 0; kt < n_wg; ++kt) {
      const bool more = kt + 1 < n_wg;
      const int k0 = kt * kWKeys;
      if (more) issue_s(sn, kt + 1);
      float alpha[2];
      if (full_tile(mask, k0, kWKeys, T_len, p.causal, q0 + 64 * wg + 16 * (warp & 3))) {
        softmax_tile<8, false>(sc, m, l, alpha, p.scale, 0u, k0 + 2 * t4, row, 0);
      } else {
        uint32_t keyok = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + 2 * t4 + c;
            const bool ok = key < T_len && (mask == nullptr || __ldg(mask + key) > 0.f);
            keyok |= static_cast<uint32_t>(ok) << (2 * j + c);
          }
        }
        softmax_tile<8>(sc, m, l, alpha, p.scale, keyok, k0 + 2 * t4, row, p.causal);
      }
      // P as bf16 A fragments: keys 16kk.. are the S n-tiles 2kk, 2kk + 1
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        }
      }
      // the previous tile's P.V (older than the S just issued) has landed:
      // its stage is free, and O can be rescaled
      if (more) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_acc(o);
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % L::S));
      rescale(o, alpha);
      // O += P.V: V MN-major (features contiguous), 64-feature boxes
      // box_kv apart, 8-key groups 1024 bytes apart; a k16 step is 2 KB
      const uint32_t vs = base + L::ring + (kt % L::S) * L::stage_bytes + NB * L::box_kv;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv(o, pa[kk], sw128_desc(vs + kk * 2048, L::box_kv, 1024));
      }
      wgmma_commit();
      if (more) {  // the next S (older than this P.V) has landed
        wgmma_wait<1>();
        fence_acc(sn);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = sn[i];
      }
    }
    wgmma_wait<0>();
    fence_acc(o);
    if (n_wg > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((n_wg - 1) % L::S));
    for (int kt = n_wg; kt < n_kt; ++kt) {  // pass the skipped tiles on
      mbar_wait(full0 + 8 * (kt % L::S), (kt / L::S) & 1);
      if (lane == 0) mbar_arrive(empty0 + 8 * (kt % L::S));
    }
    write_rows<__nv_bfloat16>(p, o, m, l, row, b, h, t4);
  }
}

// ---------------------------------------------------------------------------
// f32_3xtf32_wgmma: the 3xTF32 split on wgmma (D <= 64, 16-byte aligned)
// ---------------------------------------------------------------------------

// d[64 x 64] (+)= A[64 x 8] (K-major, shared) * B[8 x 64] (K-major, shared), TF32
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] (+)= A[64 x 8] (TF32 registers) * B[8 x 64] (K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

constexpr int kTRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kTKeys = 64;   // keys per tile
constexpr int kTThreads = 256;

struct Tf32Layout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  // K-major TF32 operands in 128-byte swizzled boxes of 32 values a row
  static constexpr uint32_t box_q = kTRows * 128;   // 128 rows x 32 features
  static constexpr uint32_t box_kv = kTKeys * 128;  // 64 rows x 32 values
  static constexpr uint32_t q_hi = 0, q_lo = 2 * box_q;
  static constexpr uint32_t k_hi = 4 * box_q, k_lo = k_hi + 2 * box_kv;
  static constexpr uint32_t vt_hi = k_lo + 2 * box_kv, vt_lo = vt_hi + 2 * box_kv;
  // raw f32 tiles as cp.async lands them, rows of 64 + 4 floats: [stage][K, V]
  static constexpr int LD = 68;
  static constexpr uint32_t stage_bytes = 2 * kTKeys * LD * 4;
  static constexpr uint32_t raw = vt_lo + 2 * box_kv;
  static constexpr uint32_t valid = raw + 2 * stage_bytes;  // [stage][kTKeys] f32
  static constexpr int bytes = valid + 2 * kTKeys * 4 + 1024;  // + alignment slack
};
static_assert(kTRows * Tf32Layout::LD * 4 <= Tf32Layout::stage_bytes,
              "Q's raw rows fit the ring's stage 1");

// The rows x 64 f32 tile src[rows][68] split into TF32 halves, stored
// K-major in two swizzled boxes each (values 0-31, 32-63 of a row).
template <int ROWS>
__device__ __forceinline__ void split_rows(const float* src, unsigned char* hi, unsigned char* lo,
                                           uint32_t box, int tid) {
#pragma unroll 4
  for (int i = tid; i < ROWS * 16; i += kTThreads) {
    const int r = i >> 4, c = i & 15;
    const float4 x = *reinterpret_cast<const float4*>(src + r * 68 + 4 * c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    const uint32_t off = (c >> 3) * box + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// V^T of the raw tile vs[64 keys][68] split into TF32 halves: row d holds
// the 64 keys of feature d, K-major, in the order in which P's accumulator
// fragments feed wgmma's A registers: within each 8 keys, logical column
// c < 4 is key 2c and c >= 4 is key 2(c - 4) + 1.
__device__ __forceinline__ void split_vt(const float* vs, unsigned char* hi, unsigned char* lo,
                                         int tid) {
#pragma unroll 4
  for (int i = tid; i < 64 * 16; i += kTThreads) {
    const int d = i & 63, lc = i >> 6;  // lc: 4 logical keys, 16 bytes of the row
    const int key = 8 * (lc >> 1) + (lc & 1);
    uint4 h, l;
    split(vs[key * 68 + d], h.x, l.x);
    split(vs[(key + 2) * 68 + d], h.y, l.y);
    split(vs[(key + 4) * 68 + d], h.z, l.z);
    split(vs[(key + 6) * 68 + d], h.w, l.w);
    const uint32_t off = (lc >> 3) * Tf32Layout::box_kv + d * 128 + (((lc & 7) ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Warpgroup wg (threads 128 wg ..) owns query rows q0 + 64 wg ..; all 256
// threads land and split each K and V tile.
__global__ void __launch_bounds__(kTThreads, 1) flash_tf32_wgmma_kernel(Params p) {
  using L = Tf32Layout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);
  float* rawf = reinterpret_cast<float*>(sb + L::raw);
  float* valid = reinterpret_cast<float*>(sb + L::valid);
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int T_len = p.T, D = p.D;
  const int n_qt = (T_len + kTRows - 1) / kTRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kTRows;  // longest first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
  int n_kt = (T_len + kTKeys - 1) / kTKeys;
  if (p.causal) n_kt = min(n_kt, (min(q0 + kTRows, T_len) - 1) / kTKeys + 1);

  auto load_kv = [&](int kt) {
    const int st = kt & 1, k0 = kt * kTKeys;
    float* ks = rawf + st * (L::stage_bytes / 4);
    load_rows<float, 64, true, kTKeys, kTThreads>(ks, k, p.k_st, k0, T_len, D, tid);
    load_rows<float, 64, true, kTKeys, kTThreads>(ks + kTKeys * L::LD, v, p.v_st, k0, T_len, D,
                                                  tid);
    if (tid < kTKeys) {
      const int t = k0 + tid;
      valid[st * kTKeys + tid] = (t < T_len && (mask == nullptr || mask[t] > 0.f)) ? 1.f : 0.f;
    }
  };
  // Q into the raw ring's stage 1 (free until tile 1 is loaded), then split
  float* qraw = rawf + L::stage_bytes / 4;
  load_rows<float, 64, true, kTRows, kTThreads>(qraw, q, p.q_st, q0, T_len, D, tid);
  load_kv(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_rows<kTRows>(qraw, sb + L::q_hi, sb + L::q_lo, L::box_q, tid);
  __syncthreads();  // Q's raw rows are read before tile 1 lands on them

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 64 * wg + 16 * (warp & 3);  // this warp's first row
  const int row[2] = {row0 + (lane >> 2), row0 + (lane >> 2) + 8};
  const int wg_last = q0 + 64 * wg + 63;
  const uint32_t qh = base + L::q_hi + wg * 64 * 128, ql = base + L::q_lo + wg * 64 * 128;
  // the k8 step kk of a K-major operand: box kk / 4, 32 bytes along the row
  auto at = [](uint32_t addr, uint32_t box, int kk) {
    return sw128_desc(addr + (kk >> 2) * box + (kk & 3) * 32, 16, 1024);
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();  // (possibly empty: keeps the group count uniform)
    cp_async_wait<1>();
    __syncthreads();  // tile kt has landed for every thread
    const int st = kt & 1, k0 = kt * kTKeys;
    const float* ks = rawf + st * (L::stage_bytes / 4);
    split_rows<kTKeys>(ks, sb + L::k_hi, sb + L::k_lo, L::box_kv, tid);
    split_vt(ks + kTKeys * L::LD, sb + L::vt_hi, sb + L::vt_lo, tid);
    fence_async_smem();  // the halves, written by these threads, are read by wgmma
    __syncthreads();

    if (!p.causal || k0 <= wg_last) {  // a tile wholly above the warpgroup's rows adds nothing
      // S = Q.K^T in four groups of 16 features, each into fresh
      // accumulators summed here in f32 (the tensor cores' sums are not
      // rounded to nearest); each product as lo.hi + hi.lo + hi.hi
      float s[32], acc[2][32];
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        float(&a)[32] = acc[grp & 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 2 * grp; kk < 2 * grp + 2; ++kk) {
          wgmma_tf32_ss(a, at(ql, L::box_q, kk), at(base + L::k_hi, L::box_kv, kk),
                        kk != 2 * grp);
          wgmma_tf32_ss(a, at(qh, L::box_q, kk), at(base + L::k_lo, L::box_kv, kk), 1);
          wgmma_tf32_ss(a, at(qh, L::box_q, kk), at(base + L::k_hi, L::box_kv, kk), 1);
        }
        wgmma_commit();
        if (grp > 0) {
          wgmma_wait<1>();
          float(&done)[32] = acc[(grp - 1) & 1];
          fence_acc(done);
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = grp == 1 ? done[i] : s[i] + done[i];
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += acc[1][i];

      float alpha[2];
      if (full_tile(mask, k0, kTKeys, T_len, p.causal, row0)) {
        softmax_tile<8, false>(s, m, l, alpha, p.scale, 0u, k0 + 2 * t4, row, 0);
      } else {
        const float* kok = valid + st * kTKeys;
        uint32_t keyok = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            keyok |= static_cast<uint32_t>(kok[8 * j + 2 * t4 + c] > 0.f) << (2 * j + c);
          }
        }
        softmax_tile<8>(s, m, l, alpha, p.scale, keyok, k0 + 2 * t4, row, p.causal);
      }

      // P as TF32 halves in wgmma's A registers: the accumulator fragment of
      // keys 8kk.. is the A fragment of logical step kk (V^T's key order)
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        split(s[4 * kk], ph[kk][0], pl[kk][0]);
        split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
        split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
        split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      float part[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_tf32_rs(part, pl[kk], at(base + L::vt_hi, L::box_kv, kk), kk > 0);
        wgmma_tf32_rs(part, ph[kk], at(base + L::vt_lo, L::box_kv, kk), 1);
        wgmma_tf32_rs(part, ph[kk], at(base + L::vt_hi, L::box_kv, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], part[i]);
    }
    __syncthreads();  // both warpgroups are done with the halves and the stage
  }
  write_rows<float>(p, o, m, l, row, b, h, t4);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver entry point, reached through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// A [B,T,H,D] bf16 view as a 4-D map over (D, H, T, B) with its strides, in
// boxes of 64 features x 1 head x `rows` steps x 1 batch, 128-byte swizzle,
// zeros outside the view.
cudaError_t view_map(CUtensorMap* map, const void* ptr, long long sb, long long st, long long sh,
                     const Params& p, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.T), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

template <typename T, int DP, bool VEC>
cudaError_t launch_mma(const Params& p, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_mma_kernel<T, DP, VEC>;
  const cudaError_t err = allow_smem(kernel, MmaLayout<DP>::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + MmaLayout<DP>::ROWS - 1) / MmaLayout<DP>::ROWS, p.B * p.H);
  kernel<<<grid, MmaLayout<DP>::THREADS, MmaLayout<DP>::bytes, s>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wgmma(const Params& p, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_wgmma_kernel<DP>;
  cudaError_t err = allow_smem(kernel, WgLayout<DP>::bytes, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if ((err = view_map(&qmap, p.q, p.q_sb, p.q_st, p.q_sh, p, kWRows)) != cudaSuccess) return err;
  if ((err = view_map(&kmap, p.k, p.k_sb, p.k_st, p.k_sh, p, kWKeys)) != cudaSuccess) return err;
  if ((err = view_map(&vmap, p.v, p.v_sb, p.v_st, p.v_sh, p, kWKeys)) != cudaSuccess) return err;
  const dim3 grid((p.T + kWRows - 1) / kWRows, p.B * p.H);
  kernel<<<grid, kWThreads, WgLayout<DP>::bytes, s>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

cudaError_t launch_tf32_wgmma(const Params& p, cudaStream_t s) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(flash_tf32_wgmma_kernel, Tf32Layout::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTRows - 1) / kTRows, p.B * p.H);
  flash_tf32_wgmma_kernel<<<grid, kTThreads, Tf32Layout::bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_mma(const Params& p, int dp, cudaStream_t s) {
  return dp == 64 ? launch_mma<T, 64, VEC>(p, s) : launch_mma<T, 128, VEC>(p, s);
}

// The compiled configurations: (variant, feature width DP).
bool compiled(int variant, int dp) {
  if (variant == kF32Tf32x3Wgmma) return dp == 64;
  if (variant == kF32Tf32x3) return dp == 128;
  return variant >= kF32Tf32x3 && variant <= kBf16Unaligned && (dp == 64 || dp == 128);
}

int smem_bytes(int variant, int dp) {
  if (variant == kF32Tf32x3Wgmma) return Tf32Layout::bytes;
  if (variant == kBf16Wgmma) return dp == 64 ? WgLayout<64>::bytes : WgLayout<128>::bytes;
  return dp == 64 ? MmaLayout<64>::bytes : MmaLayout<128>::bytes;
}

template <typename K>
cudaError_t occupancy_of(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <typename T, bool VEC>
cudaError_t occupancy_mma(int dp, int* blocks) {
  const int smem = dp == 64 ? MmaLayout<64>::bytes : MmaLayout<128>::bytes;
  if (dp == 64) {
    return occupancy_of(flash_mma_kernel<T, 64, VEC>, MmaLayout<64>::THREADS, smem, blocks);
  }
  return occupancy_of(flash_mma_kernel<T, 128, VEC>, MmaLayout<128>::THREADS, smem, blocks);
}

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

}  // namespace

// One flash forward on the variant and feature width of the plan from
// ops/attention.py. q, k, v [B,T,H,D] through element strides (batch, time,
// head; the feature axis contiguous), f32 for variants 0, 1 and 4, bf16 for 2 and 3;
// mask [B,T] f32 or null; out [B,T,H,D] contiguous in that dtype, lse
// [B,H,T] f32. The variant's alignment rules must hold and D <= dp. Returns
// the first cudaError_t met (0 on success); nothing is launched on a refusal.
extern "C" int flash_attn_launch(int variant, int dp, const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* lse, long long q_sb,
                                 long long q_st, long long q_sh, long long k_sb, long long k_st,
                                 long long k_sh, long long v_sb, long long v_st, long long v_sh,
                                 int B, int H, int T, int D, int causal, float scale, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || T < 1 || D < 1 || D > dp || B * H > 65535 || !compiled(variant, dp)) {
    return inval;
  }
  const long long strides[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  if (variant == kF32Tf32x3 || variant == kF32Tf32x3Wgmma || variant == kBf16Wgmma) {
    const int elems = variant == kBf16Wgmma ? 8 : 4;  // 16 bytes
    if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16)) return inval;
    for (long long st : strides) {
      if (st % elems != 0) return inval;
    }
    if (variant != kBf16Wgmma && D % 4 != 0) return inval;
  }
  Params p{q, k, v, static_cast<const float*>(mask), out, static_cast<float*>(lse),
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           B, H, T, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kF32Tf32x3Wgmma: err = launch_tf32_wgmma(p, s); break;
    case kF32Tf32x3: err = launch_mma<float, 128, true>(p, s); break;
    case kF32Tf32x3Unaligned: err = dispatch_mma<float, false>(p, dp, s); break;
    case kBf16Unaligned: err = dispatch_mma<__nv_bfloat16, false>(p, dp, s); break;
    default: err = dp == 64 ? launch_wgmma<64>(p, s) : launch_wgmma<128>(p, s);
  }
  return static_cast<int>(err);
}

// Shared memory (bytes) a block of the configuration takes, as plan() counts
// it; -1 for a configuration that is not compiled.
extern "C" int flash_attn_smem_bytes(int variant, int dp) {
  return compiled(variant, dp) ? smem_bytes(variant, dp) : -1;
}

// Blocks of the configuration that fit on one SM of `device`, into *blocks.
extern "C" int flash_attn_occupancy(int variant, int dp, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!compiled(variant, dp)) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case kF32Tf32x3Wgmma:
      err = occupancy_of(flash_tf32_wgmma_kernel, kTThreads, Tf32Layout::bytes, blocks);
      break;
    case kF32Tf32x3:
      err = occupancy_of(flash_mma_kernel<float, 128, true>, MmaLayout<128>::THREADS,
                         MmaLayout<128>::bytes, blocks);
      break;
    case kF32Tf32x3Unaligned: err = occupancy_mma<float, false>(dp, blocks); break;
    case kBf16Unaligned: err = occupancy_mma<__nv_bfloat16, false>(dp, blocks); break;
    default:
      err = dp == 64 ? occupancy_of(flash_wgmma_kernel<64>, kWThreads, WgLayout<64>::bytes, blocks)
                     : occupancy_of(flash_wgmma_kernel<128>, kWThreads, WgLayout<128>::bytes,
                                    blocks);
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// the mma.sync variants of ops/attention.py plan_bwd(), which f32 calls
// with 64 < D <= 128 (f32_3xtf32) and views off 16 bytes
// (f32_3xtf32_unaligned, bf16_tf32) take; aligned calls at D <= 64 in f32
// and aligned bf16 calls take csrc/flash_attn_bwd_wgmma.cu.
//
// Replaces the JAX package's _bwd_core of
// deeplearning4j_tpu/ops/attention_pallas.py:321 (reached through
// _attention_bwd :397 and _flash_block_bwd :438), which XLA compiles around
// the Pallas forward there; here it is a kernel of its own.
//
// Contract (_bwd_core), per (batch b, head h), rows r and keys c < T:
//   valid  = mask[b, c] > 0  and  (not causal or c <= r)
//   delta  = rowsum(dO . O)                               f32
//   P      = valid ? exp(S * scale - lse[r]) : 0           S = Q.K^T, f32 accumulation
//   dP     = dO.V^T
//   dS     = P * (dP - delta[r])  (+ P * g_lse[r])
//   dV     = round(P)^T.dO;  dQ = round(dS).K * scale;  dK = round(dS)^T.Q * scale
// round() is to the input dtype (bf16: JAX's pc and ds.astype); products
// accumulate in f32. An invalid entry is exactly 0 before use: on a fully
// masked row lse is the -1e30 sentinel and exp would give ~1. q, k, v are
// [B, T, H, D] read through element strides (batch, time, head; the
// feature axis contiguous), so the views of one [B, T, 3, H, D] projection
// are read in place; out and dO are [B, T, H, D] contiguous, lse and g_lse
// [B, H, T] f32, mask [B, T] f32 or null; dq, dk, dv [B, T, H, D]
// contiguous in q's dtype. D <= 128, any T.
//
// What bounds it on an H100 SXM: at the training path's shape (B=4, H=8,
// T=4096, D=64, causal) the five products of the contract take
// 10*B*H*D*T(T+1)/2 = 171.8 GFLOP against ~50 MB moved in f32: bound by
// operations, 2.565 ms at the CUDA cores' 67 TFLOP/s f32 rate, 1.041 ms as
// three TF32 products each on the tensor cores (495 TFLOP/s), 0.174 ms in
// bf16 (989 TFLOP/s).
//
// Design: two passes, no float atomics, so two calls on the same inputs
// give the same bits (as _bwd_core's ordered scan does).
//   flash_bwd_dq_kernel: one block per (query tile of 64 rows, b.h). It
//     computes delta for its rows (written to a [B, H, T] f32 scratch for
//     the second pass) and sweeps the key tiles up to the causal diagonal:
//     S and dP recomputed, dQ += dS.K kept in registers.
//   flash_bwd_dkdv_kernel: one block per (key tile of 64 keys, b.h). It
//     sweeps the query tiles from the diagonal down, recomputing S^T = K.Q^T
//     and dP^T = V.dO^T with the keys as rows, and keeps dK += dS^T.Q and
//     dV += P^T.dO in registers.
// That is 7 products instead of 5 (S and dP twice): 1.46 ms at 3xTF32.
// Tiles run longest first, as the forward's do. Warps of 16 rows; the rows
// a block keeps (Q and dO, or K and V) are read once, the swept tiles of 64
// stream through a cp.async double buffer (rows padded to DP + 4 floats, so
// fragment reads hit 32 banks), beside the per-column vectors (key-valid
// flags; or lse, delta and g_lse). DP = 64 (the training path): 8 warps
// keep 128 rows, and each swept tile is split into its TF32 halves once, in
// shared memory, for all of them (172 KB). DP = 128: 4 warps keep 64 rows
// and split the fragments they read (the halves would not fit; 200 KB).
// f32_3xtf32 copies in 16 bytes, f32_3xtf32_unaligned (views off 16 bytes,
// read in place) in 4: a flag of the same compiled kernels.
//
// f32 runs on the tensor cores (mma.sync m16n8k8) with the forward's
// 3xTF32 split (csrc/flash_attn.cu; the helpers are repeated here, each
// source being its own library): x = hi + lo, hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), each product as lo.hi + hi.lo + hi.hi. One-pass
// TF32 would not meet the f32 gradient tolerance and is never used on f32.
// The forward's drift rule holds: the tensor cores do not round their f32
// sums to nearest, so S and dP are summed 16 features at a time into fresh
// accumulators, and each tile's dQ, dK or dV product starts from zero and
// is added to the running sum on the CUDA cores. The kept rows' operands
// are split as their fragments are read. The accumulator fragment of S (or
// dS) is the A fragment of the next product, lane for lane, with the keys
// of each 8-step taken in the order (0, 2, 4, 6, 1, 3, 5, 7), as in the
// forward.
// bf16 (variant bf16_tf32) widens its operands exactly into shared memory
// and takes the same body in one TF32 pass, exact on bf16 operands (and on
// P and dS once they are rounded to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Variant { kF32Tf32x3 = 0, kF32Tf32x3Unaligned = 1, kBf16Tf32 = 2 };
// the passes a launch runs (a bit each): both on every call of the port;
// one alone only where a pass is timed apart (the dk/dv pass reads the delta
// the dq pass wrote)
enum Pass { kDqPass = 1, kDkDvPass = 2 };

constexpr int kCols = 64;  // columns a swept tile holds: keys (dq pass) or queries (dkdv pass)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;
  const float* glse;
  const float* mask;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int B, H, T, D, causal;
  int vec;  // f32 in 16-byte copies (f32_3xtf32), else 4-byte ones
  float scale;
};

// DP = 64: 8 warps keep 128 rows, the swept tiles split once in shared
// memory; DP = 128: 4 warps keep 64 rows and split what they read.
template <int DP>
struct Layout {  // float offsets into dynamic shared memory
  static constexpr bool PRESPLIT = DP == 64;
  static constexpr int ROWS = PRESPLIT ? 128 : 64;  // rows a block keeps: query rows or keys
  static constexpr int THREADS = 2 * ROWS;          // warps of 16 rows
  static constexpr int LD = DP + 4;
  static constexpr int tile = kCols * LD;           // one swept tile
  static constexpr int fixed = 0;                   // [Q, dO] (dq pass) or [K, V] (dkdv pass)
  static constexpr int ring = 2 * ROWS * LD;        // [stage][2 swept tiles]
  static constexpr int lo = ring + 4 * tile;        // [2 tiles]: the current stage's lo halves
  static constexpr int vec = lo + (PRESPLIT ? 2 * tile : 0);  // [stage][3][kCols]
  static constexpr int rowv = vec + 2 * 3 * kCols;  // [ROWS]: the dq pass's delta
  static constexpr int bytes = (rowv + ROWS) * 4;
};

// ---------------------------------------------------------------------------
// PTX helpers (as in csrc/flash_attn.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
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

__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c[16 x 8] = a . b, starting from zero
__device__ __forceinline__ void mma_tf32_first(float* c, const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* out, float x) { *out = x; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float x) { *out = __float2bfloat16(x); }

// One operand value as TF32 halves (F32: the 3xTF32 split; else the value is
// exact in TF32 and lo is unused)
template <bool F32>
__device__ __forceinline__ void halves(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (F32) {
    split(x, hi, lo);
  } else {
    hi = f2u(x);
    lo = 0u;
  }
}

// ROWS rows r0.. of src (row stride st elements) into dst[ROWS][DP + 4] as
// f32; zeros past T and past D. f32 with `vec` in 16-byte copies (D % 4 ==
// 0, so a chunk is all in or all out; a uniform branch, which keeps one
// compiled kernel for both f32 variants), else in 4-byte copies; bf16
// widened (exact) as it is stored.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long st, int r0,
                                          int T_len, int D, int tid, int vec) {
  constexpr int LD = DP + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CH = DP / 4;
#pragma unroll 4
      for (int i = tid; i < ROWS * CH; i += NT) {
        const int r = i / CH, c = (i - r * CH) * 4, t = r0 + r;
        const bool ok = t < T_len && c < D;
        cp_async16(smem_u32(dst + r * LD + c), ok ? src + t * st + c : src, ok);
      }
      return;
    }
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP, t = r0 + r;
      const bool ok = t < T_len && c < D;
      cp_async4(smem_u32(dst + r * LD + c), ok ? src + t * st + c : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP, t = r0 + r;
      dst[r * LD + c] = (t < T_len && c < D) ? __bfloat162float(src[t * st + c]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// the two products every tile takes
// ---------------------------------------------------------------------------

// A B-fragment value of a swept tile as TF32 halves: PRE, read split from
// shared memory (lo at `lo_off` floats past hi); else split here.
template <bool F32, bool PRE>
__device__ __forceinline__ void bfrag(const float* at, int lo_off, uint32_t& hi, uint32_t& lo) {
  if constexpr (PRE) {
    hi = f2u(at[0]);
    lo = f2u(at[lo_off]);
  } else {
    halves<F32>(at[0], hi, lo);
  }
}

// c[16 x 64] = A[16 x DP] . B[64 x DP]^T: A the warp's 16 rows (`a` points at
// row g, feature t4, of a [.][DP + 4] tile), B the 64 rows of the swept tile
// `bs` (lo halves `lo_off` floats past, where PRE). 16 features at a time
// into fresh accumulators, added in f32.
// Accumulator n-tile j, element e: row g + 8 (e >> 1), column 8j + 2 t4 + (e & 1).
template <bool F32, bool PRE, int DP>
__device__ __forceinline__ void product_abt(float (&c)[32], const float* a, const float* bs,
                                            int lo_off, int g, int t4) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < DP / 8; kc += 2) {
    float part[32];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 8 * (kc + half);
      const float av[4] = {a[col], a[8 * LD + col], a[col + 4], a[8 * LD + col + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) halves<F32>(av[x], ah[x], al[x]);
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* br = bs + (8 * j + g) * LD + col + t4;
        bfrag<F32, PRE>(br, lo_off, bh[j][0], bl[j][0]);
        bfrag<F32, PRE>(br + 4, lo_off, bh[j][1], bl[j][1]);
      }
      if constexpr (F32) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (half == 0) {
            mma_tf32_first(part + 4 * j, al, bh[j]);
          } else {
            mma_tf32(part + 4 * j, al, bh[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part + 4 * j, ah, bl[j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part + 4 * j, ah, bh[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (half == 0) {
            mma_tf32_first(part + 4 * j, ah, bh[j]);
          } else {
            mma_tf32(part + 4 * j, ah, bh[j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] += part[i];
  }
}

// acc[16 x DP] += X[16 x 64] . B[64 x DP]: X the accumulator fragments of a
// [16 x 64] product (S's layout; overwritten with its hi halves), B the 64
// rows of the swept tile `bs`. The tile's product gathers in fresh
// registers, 64 features at a time, and is added to acc in f32.
template <bool F32, bool PRE, int DP>
__device__ __forceinline__ void product_xb(float (&acc)[DP / 2], float (&x)[32], const float* bs,
                                           int lo_off, int g, int t4) {
  constexpr int LD = DP + 4;
  float xl[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    uint32_t hi, lo;
    halves<F32>(x[i], hi, lo);
    x[i] = __uint_as_float(hi);
    xl[i] = __uint_as_float(lo);
  }
#pragma unroll
  for (int fc = 0; fc < DP / 64; ++fc) {
    float part[32];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // the keys of this 8-step in the order (0, 2, 4, 6, 1, 3, 5, 7): the
      // accumulator fragment is then the A fragment as it stands
      const uint32_t ah[4] = {f2u(x[4 * kk]), f2u(x[4 * kk + 2]), f2u(x[4 * kk + 1]),
                              f2u(x[4 * kk + 3])};
      const uint32_t al[4] = {f2u(xl[4 * kk]), f2u(xl[4 * kk + 2]), f2u(xl[4 * kk + 1]),
                              f2u(xl[4 * kk + 3])};
      const float* br = bs + (8 * kk + 2 * t4) * LD + 64 * fc + g;
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        bfrag<F32, PRE>(br + 8 * dn, lo_off, bh[dn][0], bl[dn][0]);
        bfrag<F32, PRE>(br + 8 * dn + LD, lo_off, bh[dn][1], bl[dn][1]);
      }
      if constexpr (F32) {
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          if (kk == 0) {
            mma_tf32_first(part + 4 * dn, al, bh[dn]);
          } else {
            mma_tf32(part + 4 * dn, al, bh[dn]);
          }
        }
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) mma_tf32(part + 4 * dn, ah, bl[dn]);
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) mma_tf32(part + 4 * dn, ah, bh[dn]);
      } else {
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          if (kk == 0) {
            mma_tf32_first(part + 4 * dn, ah, bh[dn]);
          } else {
            mma_tf32(part + 4 * dn, ah, bh[dn]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * fc + i] += part[i];
  }
}

// The current stage's two swept tiles split once for all warps: hi in
// place, lo at `lo` (PRE only), then a barrier.
template <int DP, int NT>
__device__ __forceinline__ void split_stage(float* hs, float* lo, int tid) {
  for (int i = tid; i < 2 * kCols * (DP + 4); i += NT) {
    uint32_t hi, l;
    split(hs[i], hi, l);
    hs[i] = __uint_as_float(hi);
    lo[i] = __uint_as_float(l);
  }
  __syncthreads();
}

// acc * mul into the thread's two rows of a [B, T, H, D] contiguous tensor
// (n-tile j of acc: features 8j + 2 t4 + c, element 2r + c)
template <typename T, int DP>
__device__ __forceinline__ void store_rows(void* dst, const float (&acc)[DP / 2], float mul,
                                           const int (&row)[2], const Params& p, int b, int h,
                                           int t4) {
  T* out = static_cast<T*>(dst);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.T) continue;
    const long long base = ((static_cast<long long>(b) * p.T + row[r]) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * t4 + c;
        if (d < p.D) store(out + base + d, acc[4 * j + 2 * r + c] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: delta and dQ
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<DP>::THREADS, 1) flash_bwd_dq_kernel(Params p) {
  using L = Layout<DP>;
  constexpr int LD = L::LD, ROWS = L::ROWS, NT = L::THREADS;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kPre = kF32 && L::PRESPLIT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int T_len = p.T, D = p.D;
  const int n_qt = (T_len + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * ROWS;  // longest first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long sd = static_cast<long long>(p.H) * D;  // time stride of out and dO
  const long long cbase = static_cast<long long>(b) * T_len * sd + static_cast<long long>(h) * D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* o = static_cast<const T*>(p.o) + cbase;
  const T* gr = static_cast<const T*>(p.g) + cbase;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
  const long long vbase = static_cast<long long>(bh) * T_len;

  int n_kt = (T_len + kCols - 1) / kCols;
  if (p.causal) n_kt = min(n_kt, (min(q0 + ROWS, T_len) - 1) / kCols + 1);

  float* qs = sm + L::fixed;
  float* gs = qs + ROWS * LD;
  auto load_kv = [&](int kt) {
    const int st = kt & 1, k0 = kt * kCols;
    float* ks = sm + L::ring + st * 2 * L::tile;
    load_rows<T, DP, kCols, NT>(ks, k, p.k_st, k0, T_len, D, tid, p.vec);
    load_rows<T, DP, kCols, NT>(ks + L::tile, v, p.v_st, k0, T_len, D, tid, p.vec);
    if (tid < kCols) {
      const int t = k0 + tid;
      sm[L::vec + st * 3 * kCols + tid] =
          (t < T_len && (mask == nullptr || mask[t] > 0.f)) ? 1.f : 0.f;
    }
  };
  load_rows<T, DP, ROWS, NT>(qs, q, p.q_st, q0, T_len, D, tid, p.vec);
  load_rows<T, DP, ROWS, NT>(gs, gr, sd, q0, T_len, D, tid, p.vec);
  load_kv(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO . O) in f32, in feature order
  if (tid < ROWS) {
    const int t = q0 + tid;
    float acc = 0.f;
    if (t < T_len) {
      const T* orow = o + t * sd;
      for (int d = 0; d < D; ++d) acc += gs[tid * LD + d] * to_f32(orow[d]);
      p.delta[vbase + t] = acc;
    }
    sm[L::rowv + tid] = acc;
  }
  __syncthreads();

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse_r[2], dl_r[2], gl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < T_len;
    lse_r[r] = in ? p.lse[vbase + row[r]] : 0.f;
    dl_r[r] = sm[L::rowv + 16 * warp + g + 8 * r];
    gl_r[r] = (in && p.glse != nullptr) ? p.glse[vbase + row[r]] : 0.f;
  }
  const float* qa = qs + (16 * warp + g) * LD + t4;
  const float* ga = gs + (16 * warp + g) * LD + t4;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);
    cp_async_commit();  // (possibly empty: keeps the group count uniform)
    cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1, k0 = kt * kCols;
    float* ks = sm + L::ring + st * 2 * L::tile;
    const float* vs = ks + L::tile;
    const float* kok = sm + L::vec + st * 3 * kCols;
    const int lo_off = L::lo - (L::ring + st * 2 * L::tile);
    if constexpr (kPre) split_stage<DP, NT>(ks, sm + L::lo, tid);
    // a causal tile wholly after the warp's rows adds nothing
    if (!p.causal || k0 <= q0 + 16 * warp + 15) {
      float s[32], dp[32];
      product_abt<kF32, kPre, DP>(s, qa, ks, lo_off, g, t4);  // S = Q.K^T
      product_abt<kF32, kPre, DP>(dp, ga, vs, lo_off, g, t4);  // dP = dO.V^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
          const bool valid = row[r] < T_len && kok[c] > 0.f && (!p.causal || k0 + c <= row[r]);
          const float pv = valid ? __expf(s[4 * j + e] * p.scale - lse_r[r]) : 0.f;
          float ds = pv * (dp[4 * j + e] - dl_r[r]);
          if (p.glse != nullptr) ds += pv * gl_r[r];
          s[4 * j + e] = kF32 ? ds : round_bf16(ds);
        }
      }
      product_xb<kF32, kPre, DP>(dq, s, ks, lo_off, g, t4);  // dQ += dS.K
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<T, DP>(p.dq, dq, p.scale, row, p, b, h, t4);
}

// ---------------------------------------------------------------------------
// pass 2: dK and dV
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<DP>::THREADS, 1) flash_bwd_dkdv_kernel(Params p) {
  using L = Layout<DP>;
  constexpr int LD = L::LD, ROWS = L::ROWS, NT = L::THREADS;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kPre = kF32 && L::PRESPLIT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int T_len = p.T, D = p.D;
  // key tile 0 sweeps the most query tiles under causal masking: longest first
  const int k0 = static_cast<int>(blockIdx.x) * ROWS;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const long long sd = static_cast<long long>(p.H) * D;
  const long long cbase = static_cast<long long>(b) * T_len * sd + static_cast<long long>(h) * D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gr = static_cast<const T*>(p.g) + cbase;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
  const long long vbase = static_cast<long long>(bh) * T_len;
  const float* lse = p.lse + vbase;
  const float* delta = p.delta + vbase;
  const float* glse = p.glse == nullptr ? nullptr : p.glse + vbase;

  const int n_qt = (T_len + kCols - 1) / kCols;
  const int qt0 = p.causal ? k0 / kCols : 0;

  float* ks = sm + L::fixed;
  float* vs = ks + ROWS * LD;
  auto load_q = [&](int qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kCols;
    float* qsb = sm + L::ring + st * 2 * L::tile;
    load_rows<T, DP, kCols, NT>(qsb, q, p.q_st, q0, T_len, D, tid, p.vec);
    load_rows<T, DP, kCols, NT>(qsb + L::tile, gr, sd, q0, T_len, D, tid, p.vec);
    if (tid < kCols) {
      float* vec = sm + L::vec + st * 3 * kCols;
      const int t = q0 + tid;
      const bool in = t < T_len;
      vec[tid] = in ? lse[t] : 0.f;
      vec[kCols + tid] = in ? delta[t] : 0.f;
      vec[2 * kCols + tid] = (in && glse != nullptr) ? glse[t] : 0.f;
    }
  };
  load_rows<T, DP, ROWS, NT>(ks, k, p.k_st, k0, T_len, D, tid, p.vec);
  load_rows<T, DP, ROWS, NT>(vs, v, p.v_st, k0, T_len, D, tid, p.vec);
  load_q(qt0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_ok[r] = key[r] < T_len && (mask == nullptr || mask[key[r]] > 0.f);
  }
  const float* ka = ks + (16 * warp + g) * LD + t4;
  const float* va = vs + (16 * warp + g) * LD + t4;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_q(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = (qt - qt0) & 1, q0 = qt * kCols;
    float* qsb = sm + L::ring + st * 2 * L::tile;
    const float* gsb = qsb + L::tile;
    const float* vec = sm + L::vec + st * 3 * kCols;
    const int lo_off = L::lo - (L::ring + st * 2 * L::tile);
    if constexpr (kPre) split_stage<DP, NT>(qsb, sm + L::lo, tid);
    // a causal tile wholly before the warp's keys adds nothing
    if (!p.causal || k0 + 16 * warp <= q0 + kCols - 1) {
      float s[32], dp[32];
      product_abt<kF32, kPre, DP>(s, ka, qsb, lo_off, g, t4);  // S^T = K.Q^T
      product_abt<kF32, kPre, DP>(dp, va, gsb, lo_off, g, t4);  // dP^T = V.dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1), t = q0 + c;
          const bool valid = key_ok[r] && t < T_len && (!p.causal || key[r] <= t);
          const float pv = valid ? __expf(s[4 * j + e] * p.scale - vec[c]) : 0.f;
          float ds = pv * (dp[4 * j + e] - vec[kCols + c]);
          if (glse != nullptr) ds += pv * vec[2 * kCols + c];
          s[4 * j + e] = kF32 ? pv : round_bf16(pv);
          dp[4 * j + e] = kF32 ? ds : round_bf16(ds);
        }
      }
      product_xb<kF32, kPre, DP>(dv, s, gsb, lo_off, g, t4);   // dV += P^T.dO
      product_xb<kF32, kPre, DP>(dk, dp, qsb, lo_off, g, t4);  // dK += dS^T.Q
    }
    __syncthreads();
  }
  store_rows<T, DP>(p.dk, dk, p.scale, key, p, b, h, t4);
  store_rows<T, DP>(p.dv, dv, 1.f, key, p, b, h, t4);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int DP>
constexpr int smem_of() {
  return Layout<DP>::bytes;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int passes, cudaStream_t s) {
  static bool dq_set = false, dkdv_set = false;
  constexpr int smem = smem_of<DP>();
  auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DP>;
  cudaError_t err = allow_smem(dq_kernel, smem, dq_set);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(dkdv_kernel, smem, dkdv_set)) != cudaSuccess) return err;
  constexpr int rows = Layout<DP>::ROWS;
  const dim3 grid((p.T + rows - 1) / rows, p.B * p.H);
  if (passes & kDqPass) {
    dq_kernel<<<grid, Layout<DP>::THREADS, smem, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & kDkDvPass) {
    dkdv_kernel<<<grid, Layout<DP>::THREADS, smem, s>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t dispatch(const Params& p, int dp, int passes, cudaStream_t s) {
  return dp == 64 ? launch<T, 64>(p, passes, s) : launch<T, 128>(p, passes, s);
}

bool compiled(int variant, int dp) {
  return variant >= kF32Tf32x3 && variant <= kBf16Tf32 && (dp == 64 || dp == 128);
}

template <typename K>
cudaError_t occupancy_of(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

// the fewer blocks an SM of the two kernels
template <typename T, int DP>
cudaError_t occupancy(int* blocks) {
  int a = 0, c = 0;
  constexpr int threads = Layout<DP>::THREADS;
  cudaError_t err = occupancy_of(flash_bwd_dq_kernel<T, DP>, threads, smem_of<DP>(), &a);
  if (err != cudaSuccess) return err;
  err = occupancy_of(flash_bwd_dkdv_kernel<T, DP>, threads, smem_of<DP>(), &c);
  *blocks = a < c ? a : c;
  return err;
}

template <typename T>
cudaError_t occupancy_dp(int dp, int* blocks) {
  return dp == 64 ? occupancy<T, 64>(blocks) : occupancy<T, 128>(blocks);
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// One flash backward (the passes `passes` names, a Pass bit each: 3 for
// both, on `stream`) on the variant and feature width of the plan from
// ops/attention.py plan_bwd(): 0 f32_3xtf32 (q, k,
// v, out, dO on 16 bytes; strides and D multiples of 4), 1
// f32_3xtf32_unaligned, 2 bf16_tf32. q, k, v [B,T,H,D] through element
// strides; out, dO [B,T,H,D] contiguous in their dtype; lse [B,H,T] f32;
// g_lse [B,H,T] f32 or null; mask [B,T] f32 or null; delta [B,H,T] f32
// scratch; dq, dk, dv [B,T,H,D] contiguous. Returns the first cudaError_t
// met (0 on success); nothing is launched on a refusal.
extern "C" int flash_attn_bwd_launch(int variant, int dp, int passes, const void* q,
                                     const void* k, const void* v, const void* o, const void* g,
                                     const void* lse, const void* glse, const void* mask,
                                     void* delta, void* dq, void* dk, void* dv, long long q_sb,
                                     long long q_st, long long q_sh, long long k_sb,
                                     long long k_st, long long k_sh, long long v_sb,
                                     long long v_st, long long v_sh, int B, int H, int T, int D,
                                     int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || T < 1 || D < 1 || D > dp || B * H > 65535 || !compiled(variant, dp) ||
      passes < 1 || passes > (kDqPass | kDkDvPass)) {
    return inval;
  }
  if (variant == kF32Tf32x3) {
    const long long strides[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
    if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(o) || !aligned(g) || D % 4 != 0) {
      return inval;
    }
    for (long long st : strides) {
      if (st % 4 != 0) return inval;
    }
  }
  Params p{q, k, v, o, g,
           static_cast<const float*>(lse), static_cast<const float*>(glse),
           static_cast<const float*>(mask), static_cast<float*>(delta), dq, dk, dv,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           B, H, T, D, causal, variant == kF32Tf32x3, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = variant == kBf16Tf32 ? dispatch<__nv_bfloat16>(p, dp, passes, s)
                             : dispatch<float>(p, dp, passes, s);
  return static_cast<int>(err);
}

// Shared memory (bytes) a block of either pass takes, as plan_bwd() counts
// it; -1 for a configuration that is not compiled.
extern "C" int flash_attn_bwd_smem_bytes(int variant, int dp) {
  if (!compiled(variant, dp)) return -1;
  return dp == 64 ? smem_of<64>() : smem_of<128>();
}

// Blocks of the configuration (the fewer of its two kernels) that fit on
// one SM of `device`, into *blocks.
extern "C" int flash_attn_bwd_occupancy(int variant, int dp, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!compiled(variant, dp)) return static_cast<int>(cudaErrorInvalidValue);
  err = variant == kBf16Tf32 ? occupancy_dp<__nv_bfloat16>(dp, blocks)
                             : occupancy_dp<float>(dp, blocks);
  return static_cast<int>(err);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

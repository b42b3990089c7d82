// Flash-attention backward on wgmma for NVIDIA Hopper (sm_90a), plain C
// interface: the variants f32_3xtf32_wgmma and bf16_wgmma of
// ops/attention.py plan_bwd(). csrc/flash_attn_bwd.cu keeps the mma.sync
// variants (f32_3xtf32 for 64 < D <= 128, f32_3xtf32_unaligned, bf16_tf32);
// this source is a library of its own, built beside it.
//
// Replaces, with csrc/flash_attn_bwd.cu, the JAX package's _bwd_core of
// deeplearning4j_tpu/ops/attention_pallas.py:321 (through _attention_bwd
// :397 and _flash_block_bwd :438), under the same contract (see that
// file's header): delta = rowsum(dO.O); P from lse, an invalid entry exactly
// 0 (a fully masked row gets exactly zero gradients); dS = P (dP - delta)
// (+ P g_lse); dV = P^T.dO, dQ = dS.K scale, dK = dS^T.Q scale; in bf16, P
// and dS rounded to bf16 before their products. q, k, v [B, T, H, D] are
// read in place through their strides (the views of one [B, T, 3, H, D]
// projection); out and dO [B, T, H, D] contiguous.
//
// What bounds it on an H100 SXM: at the training path's shape (B=4, H=8,
// T=4096, D=64, causal) the two passes' seven products take 240.5 GFLOP
// (the five of the contract 171.8): 1.46 ms as three TF32 products each
// (495 TFLOP/s; the dq pass 0.625, the dk/dv pass 0.833), 0.243 ms in bf16
// (989 TFLOP/s). Bound by operations either way (~50 MB moved in f32).
//
// Design: the two passes of csrc/flash_attn_bwd.cu (no float atomics, so
// two calls on the same inputs give the same bits), each a kernel: the dq
// pass keeps query rows (Q, dO) and sweeps key tiles (K, V) up to the
// causal diagonal; the dk/dv pass keeps keys (K, V) and sweeps query tiles
// (Q, dO, and the rows' lse, delta, g_lse) from it. Blocks run longest
// first across all (b, h) (grid (B H, row blocks), ranked by causal work),
// so no long block starts last. Per swept tile of 64:
//   S = X0.Y0^T and dP = X1.Y1^T   (X the kept rows, Y the tile's)
//   P, dS on the accumulator fragments (wgmma's layout is mma.sync's)
//   dq pass:   dQ += dS.K
//   dk/dv:     dV += P^T.dO and dK += dS^T.Q (P^T, dS^T: the accumulators
//              of S^T = K.Q^T and dP^T = V.dO^T, keys as rows)
// The last products contract over the tile's keys or rows, so their B
// operand (K, dO, Q) is read along its rows, not its features.
//
// f32_3xtf32_wgmma (D <= 64; q, k, v, out, dO on 16 bytes, strides and D
// multiples of 4): 128 kept rows a block, two warpgroups of 64, 256
// threads, one block an SM. Each product is the forward's 3xTF32 split
// (x = hi + lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), taken as
// lo.hi + hi.lo + hi.hi) on wgmma m64n64k8, under its drift rule: S and dP
// summed 16 features at a time into fresh accumulators, each tile's dQ, dK
// or dV product started from zero and added to the running sum on the CUDA
// cores. TF32 wgmma reads only K-major operands from shared memory, so the
// swept tile is split into TF32 halves in 128-byte swizzled boxes twice: as
// it stands (the B of S and dP) and transposed (the B of the last products,
// a row per feature holding the tile's keys or rows in P's register order
// 0, 2, 4, 6, 1, 3, 5, 7 of each 8). Transposed copies, not dS and P staged
// through shared memory: the accumulators of S and dP are then the A
// operands of the next products as they stand, in registers, and no
// warpgroup waits on another's stores. The kept rows stay raw f32 in shared
// memory (16-byte chunks XOR-swizzled by row, so a fragment read hits 32
// banks) and are read and split into register A fragments per product: the
// kept halves would take 128 KB. The dk/dv pass then holds 64 KB of kept
// rows, 128 KB of swept halves (Q, Q^T, dO, dO^T), 32 KB of raw tile and
// its vectors: 231,936 of the 232,448 bytes a block may take, so the halves
// are single-buffered and no producer can split ahead of the products. The
// overlap it has: the next tile's cp.async copies run under this tile's
// products, and each group of 16 features is split and issued while the
// group before it runs on the tensor cores.
//
// bf16_wgmma (bf16; q, k, v, dO on 16 bytes, D and strides multiples of 8,
// strides nested as TMA's maps walk them): 64 kept rows a block, one
// consumer warpgroup and one producer warp (160 threads; two blocks an SM
// at DP = 64). The producer loads the kept rows once and fills a 4-stage
// ring of swept tiles by TMA through 4-D tensor maps over the views'
// strides (64 features x 64 rows a box, 128-byte swizzle, zeros past T and
// D), and writes each stage's column vectors (key flags; or lse, delta,
// g_lse) beside it. The consumers run S and dP on wgmma m64n64k16 from
// shared memory, round P and dS to bf16 register A fragments, and run the
// last products on wgmma m64nDPk16 with B read MN-major through the
// transpose bit: no transposed copies. bf16 products accumulate on the
// tensor cores across tiles (the bf16 tolerance has room for their sums).

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ops/attention.py BWD_VARIANTS' indices (0-2 are csrc/flash_attn_bwd.cu's)
enum Variant { kF32Tf32x3Wgmma = 3, kBf16Wgmma = 4 };
// the passes a launch runs, a bit each (as csrc/flash_attn_bwd.cu)
enum Pass { kDqPass = 1, kDkDvPass = 2 };

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
  float scale;
};

// ---------------------------------------------------------------------------
// PTX helpers (as in csrc/flash_attn.cu; each source is its own library)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// one (64 features x 1 head x 64 rows x 1 batch) box of a [B,T,H,D] map
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// TF32 of x, rounded to nearest (ties away), as the tensor cores read it:
// cvt.rna.tf32.f32's result for every finite x (half an ulp of TF32 added
// to the magnitude bits, the 13 low bits cleared), in two integer
// operations; ptxas expands the cvt into a longer sequence that also keeps
// NaN and infinity, which no operand here holds
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo in TF32: hi the top 11 significant bits, lo the next 11
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// e^x on the SFU: ex2.approx of x log2(e), as __expf, with a result below
// the normal range flushed to 0 (__expf's fix-up for it costs three more
// instructions a call; such a probability adds nothing a gradient keeps)
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* out, float x) { *out = x; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float x) { *out = __float2bfloat16(x); }

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
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WGMMA_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WGMMA_D64                                                                            \
  WGMMA_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),   \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),          \
      "+f"(d[62]), "+f"(d[63])
#define WGMMA_REGS32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_REGS64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 64] (+)= A[64 x 8] (TF32 registers) * B[8 x 64] (K-major, shared)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// d[64 x 64] (+)= A[64 x 16] (K-major, shared) * B[16 x 64] (K-major, shared), bf16
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] (bf16 registers) * B[16 x 64] (MN-major, shared: tnspB = 1)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 128] += A[64 x 16] (bf16 registers) * B[16 x 128] (MN-major, shared: tnspB = 1)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc * mul into the thread's two rows of a [B, T, H, D] contiguous tensor
// (accumulator n-tile j: features 8j + 2 t4 + c, element 2r + c)
template <typename T, int NO>
__device__ __forceinline__ void store_rows(void* dst, const float (&acc)[NO], float mul,
                                           const int (&row)[2], const Params& p, int b, int h,
                                           int t4) {
  T* out = static_cast<T*>(dst);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.T) continue;
    const long long base = ((static_cast<long long>(b) * p.T + row[r]) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * j + 2 * t4 + c;
        if (d < p.D) store(out + base + d, acc[4 * j + 2 * r + c] * mul);
      }
    }
  }
}

// P and dS of one tile on the accumulator fragments (n-tile j, element e:
// row e >> 1 of the thread's two, column 8j + 2 t4 + (e & 1)): s holds S
// and dp dP; on return the dq pass's s holds dS, the dk/dv pass's s P and
// dp dS. vs: the tile's column vectors (dq pass: key flags; dk/dv pass:
// lse, delta, g_lse, 64 apart); the row vectors in registers (dq pass:
// lse_r, dl_r, gl_r; dk/dv pass: ok_r, the key flags). Branch-free: every
// input is loaded and exp taken for every entry, and an invalid entry is
// then set to exactly 0 (on a fully masked row lse is the -1e30 sentinel
// and exp would give ~1, or overflow).
template <bool DQ>
__device__ __forceinline__ void tile_grads(float (&s)[32], float (&dp)[32], const float* vs,
                                           int c0, int t4, const int (&row)[2],
                                           const float (&lse_r)[2], const float (&dl_r)[2],
                                           const float (&gl_r)[2], const bool (&ok_r)[2],
                                           const Params& p) {
  const bool glse = p.glse != nullptr;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1), i = 4 * j + e;
      if constexpr (DQ) {
        const bool valid =
            (row[r] < p.T) & (vs[c] > 0.f) & (!p.causal | (c0 + c <= row[r]));
        const float ex = exp_ftz(s[i] * p.scale - lse_r[r]);
        const float pv = valid ? ex : 0.f;
        float ds = pv * (dp[i] - dl_r[r]);
        if (glse) ds += pv * gl_r[r];
        s[i] = ds;
      } else {
        const int tq = c0 + c;
        const float lse = vs[c], dl = vs[64 + c], gl = vs[128 + c];
        const bool valid = ok_r[r] & (tq < p.T) & (!p.causal | (row[r] <= tq));
        const float ex = exp_ftz(s[i] * p.scale - lse);
        const float pv = valid ? ex : 0.f;
        float ds = pv * (dp[i] - dl);
        if (glse) ds += pv * gl;
        s[i] = pv;
        dp[i] = ds;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32_3xtf32_wgmma
// ---------------------------------------------------------------------------

constexpr int kTRows = 128;              // rows a block keeps: two warpgroups of 64
constexpr int kTCols = 64;               // columns a swept tile holds
constexpr int kTThreads = 256;
constexpr uint32_t kTBox = 64 * 128;     // 64 rows x 32 TF32 values, 128-byte swizzle
constexpr uint32_t kTCopy = 2 * kTBox;   // one operand's hi or lo halves: 64 x 64

template <bool DQ>
struct TfLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int NTR = DQ ? 1 : 2;  // transposed swept copies: K^T; or Q^T and dO^T
  static constexpr int NV = DQ ? 1 : 3;   // column vectors a stage: key flags; or lse, delta, g_lse
  // from 0: the swept halves, copy i (Y0, Y1, Y0^T, Y1^T) hi then lo at (2 i + lo) kTCopy
  static constexpr uint32_t kept = (2 + NTR) * 2 * kTCopy;   // [X0, X1] raw rows, swizzled
  static constexpr uint32_t raw = kept + 2 * kTRows * 256;   // [Y0, Y1] raw tiles
  static constexpr uint32_t vec = raw + 2 * kTCols * 256;    // [stage][NV][kTCols] f32
  static constexpr uint32_t rowv = vec + 2 * NV * kTCols * 4;  // [kTRows]: the dq pass's delta
  static constexpr int bytes = rowv + (DQ ? kTRows * 4 : 0) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t tf_copy(int i, int lo) { return (2 * i + lo) * kTCopy; }

// ROWS rows r0.. of src (row stride st floats) into dst[ROWS][64] by
// cp.async; with SWZ the 16-byte chunk c of row r lands at chunk c ^ (r & 7)
// (fragment reads then hit 32 banks). Zeros past T and past D (D % 4 == 0:
// a chunk is all in or all out).
template <int ROWS, bool SWZ>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st, int r0,
                                          int T_len, int D, int tid) {
#pragma unroll 4
  for (int i = tid; i < ROWS * 16; i += kTThreads) {
    const int r = i >> 4, c = i & 15, t = r0 + r;
    const bool ok = t < T_len && 4 * c < D;
    const int cs = SWZ ? (c ^ (r & 7)) : c;
    cp_async16(smem_u32(dst + r * 64 + 4 * cs), ok ? src + t * st + 4 * c : src, ok);
  }
}

// The raw tile src[64][64] split into TF32 halves, K-major, two swizzled
// boxes a copy (values 0-31, 32-63 of a row).
__device__ __forceinline__ void split_rows(const float* src, unsigned char* hi, unsigned char* lo,
                                           int tid) {
#pragma unroll 4
  for (int i = tid; i < 64 * 16; i += kTThreads) {
    const int r = i >> 4, c = i & 15;
    const float4 x = *reinterpret_cast<const float4*>(src + r * 64 + 4 * c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    const uint32_t off = (c >> 3) * kTBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The raw tile src[64 rows][64 features] transposed and split: row d holds
// the 64 rows of feature d, K-major, in the order in which the accumulator
// fragments of S feed wgmma's A registers: within each 8, logical column
// c < 4 is row 2c and c >= 4 is row 2(c - 4) + 1.
__device__ __forceinline__ void split_t(const float* src, unsigned char* hi, unsigned char* lo,
                                        int tid) {
#pragma unroll 4
  for (int i = tid; i < 64 * 16; i += kTThreads) {
    const int d = i & 63, lc = i >> 6;  // lc: 4 logical columns, 16 bytes of the row
    const int r = 8 * (lc >> 1) + (lc & 1);
    uint4 h, l;
    split(src[r * 64 + d], h.x, l.x);
    split(src[(r + 2) * 64 + d], h.y, l.y);
    split(src[(r + 4) * 64 + d], h.z, l.z);
    split(src[(r + 6) * 64 + d], h.w, l.w);
    const uint32_t off = (lc >> 3) * kTBox + d * 128 + (((lc & 7) ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// the k8 step kk of a K-major copy at `addr`: box kk / 4, 32 bytes along the row
__device__ __forceinline__ uint64_t tf_at(uint32_t addr, int kk) {
  return sw128_desc(addr + (kk >> 2) * kTBox + (kk & 3) * 32, 16, 1024);
}

// c[64 x 64] = X.Y^T over 64 features. X: the warpgroup's 64 kept rows in
// their swizzled raw tile (xr: the thread's row g; row g + 8 is 512 floats
// on), read and split into register A fragments here; Y: a swept copy (hi
// halves at yh, lo at yl). Four groups of 16 features, each into fresh
// accumulators summed here in f32, the next group split and issued while
// the one before it runs; each product as lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void product_xyt(float (&c)[32], const float* xr, uint32_t yh,
                                            uint32_t yl, int g, int t4) {
  float acc[2][32];
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int kk = 2 * grp + s2;
      // features 8kk + t4 (chunk 2kk) and 8kk + t4 + 4 (chunk 2kk + 1) of rows g, g + 8
      const int c0 = (((2 * kk) ^ g) << 2) + t4, c1 = (((2 * kk + 1) ^ g) << 2) + t4;
      split(xr[c0], ah[s2][0], al[s2][0]);
      split(xr[512 + c0], ah[s2][1], al[s2][1]);
      split(xr[c1], ah[s2][2], al[s2][2]);
      split(xr[512 + c1], ah[s2][3], al[s2][3]);
    }
    float(&a)[32] = acc[grp & 1];
    wgmma_fence();
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int kk = 2 * grp + s2;
      wgmma_tf32_rs(a, al[s2], tf_at(yh, kk), s2 != 0);
      wgmma_tf32_rs(a, ah[s2], tf_at(yl, kk), 1);
      wgmma_tf32_rs(a, ah[s2], tf_at(yh, kk), 1);
    }
    wgmma_commit();
    if (grp > 0) {
      wgmma_wait<1>();
      float(&done)[32] = acc[(grp - 1) & 1];
      fence_acc(done);
#pragma unroll
      for (int i = 0; i < 32; ++i) c[i] = grp == 1 ? done[i] : c[i] + done[i];
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] += acc[1][i];
}

// acc[64 x 64] += X.Y: X the accumulator fragments of a [64 x 64] product
// (S's layout), its columns the A operand's K axis in the transposed copy's
// order; Y the transposed copy (hi at yth, lo at ytl). The tile's product
// gathers in fresh registers and is added to acc in f32.
__device__ __forceinline__ void product_xb(float (&acc)[32], const float (&x)[32], uint32_t yth,
                                           uint32_t ytl) {
  uint32_t xh[8][4], xl[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    split(x[4 * kk], xh[kk][0], xl[kk][0]);
    split(x[4 * kk + 2], xh[kk][1], xl[kk][1]);
    split(x[4 * kk + 1], xh[kk][2], xl[kk][2]);
    split(x[4 * kk + 3], xh[kk][3], xl[kk][3]);
  }
  float part[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_tf32_rs(part, xl[kk], tf_at(yth, kk), kk > 0);
    wgmma_tf32_rs(part, xh[kk], tf_at(ytl, kk), 1);
    wgmma_tf32_rs(part, xh[kk], tf_at(yth, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

// One pass: DQ keeps query rows (X = Q, dO) and sweeps key tiles (Y = K, V);
// else it keeps keys (X = K, V) and sweeps query tiles (Y = Q, dO). Warpgroup
// wg (threads 128 wg ..) owns kept rows r0 + 64 wg ..; all 256 threads land
// and split each swept tile.
template <bool DQ>
__global__ void __launch_bounds__(kTThreads, 1) flash_bwd_tf32_wgmma_kernel(Params p) {
  using L = TfLayout<DQ>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base = (raw_u + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw_u);
  float* kept = reinterpret_cast<float*>(sb + L::kept);
  float* rawt = reinterpret_cast<float*>(sb + L::raw);
  float* vec = reinterpret_cast<float*>(sb + L::vec);
  float* rowv = reinterpret_cast<float*>(sb + L::rowv);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = p.T, D = p.D;
  const int n_t = (T_len + kTCols - 1) / kTCols;
  const int n_rb = (T_len + kTRows - 1) / kTRows;
  // blockIdx.y ranks the row blocks by their causal work (which grows with
  // the query rows and shrinks with the keys) and x runs over (b, h)
  // fastest, so every (b, h)'s longest block is launched before any shorter
  // one: the last blocks to start are the shortest of all
  const int r0 = (DQ ? n_rb - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y)) *
                 kTRows;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const long long sd = static_cast<long long>(p.H) * D;  // time stride of out and dO
  const long long cbase = static_cast<long long>(b) * T_len * sd + static_cast<long long>(h) * D;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gr = static_cast<const float*>(p.g) + cbase;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
  const long long vbase = static_cast<long long>(bh) * T_len;
  const float* x0 = DQ ? q : k;
  const float* x1 = DQ ? gr : v;
  const float* y0 = DQ ? k : q;
  const float* y1 = DQ ? v : gr;
  const long long x0s = DQ ? p.q_st : p.k_st, x1s = DQ ? sd : p.v_st;
  const long long y0s = DQ ? p.k_st : p.q_st, y1s = DQ ? p.v_st : sd;
  // swept tiles: the dq pass's key tiles up to its last row's diagonal; the
  // dk/dv pass's query tiles from its first key's
  int t_first = 0, t_end = n_t;
  if (p.causal) {
    if (DQ) {
      t_end = min(n_t, (min(r0 + kTRows, T_len) - 1) / kTCols + 1);
    } else {
      t_first = r0 / kTCols;
    }
  }

  auto load_y = [&](int t, int st) {
    const int c0 = t * kTCols;
    load_tile<kTCols, false>(rawt, y0, y0s, c0, T_len, D, tid);
    load_tile<kTCols, false>(rawt + kTCols * 64, y1, y1s, c0, T_len, D, tid);
    if (tid < kTCols) {
      float* vs = vec + st * L::NV * kTCols;
      const int c = c0 + tid;
      const bool in = c < T_len;
      if constexpr (DQ) {
        vs[tid] = (in && (mask == nullptr || mask[c] > 0.f)) ? 1.f : 0.f;
      } else {
        vs[tid] = in ? p.lse[vbase + c] : 0.f;
        vs[kTCols + tid] = in ? p.delta[vbase + c] : 0.f;
        vs[2 * kTCols + tid] = (in && p.glse != nullptr) ? p.glse[vbase + c] : 0.f;
      }
    }
  };
  load_tile<kTRows, true>(kept, x0, x0s, r0, T_len, D, tid);
  load_tile<kTRows, true>(kept + kTRows * 64, x1, x1s, r0, T_len, D, tid);
  if (t_first < t_end) load_y(t_first, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int R = 64 * wg + 16 * warp + g;  // the thread's first row in the block
  const int row[2] = {r0 + R, r0 + R + 8};
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, gl_r[2] = {0.f, 0.f};
  bool ok_r[2] = {false, false};
  if constexpr (DQ) {
    // delta = rowsum(dO . O) in f32, in feature order, for the second pass
    // too: the row of O in 16-byte loads issued together, dO's from the kept
    // tile
    if (tid < kTRows) {
      const int t = r0 + tid;
      float acc = 0.f;
      if (t < T_len) {
        const float4* orow =
            reinterpret_cast<const float4*>(static_cast<const float*>(p.o) + cbase + t * sd);
        const float* grow = kept + (kTRows + tid) * 64;
        float4 ov[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) ov[c] = 4 * c < D ? orow[c] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float4 gv = *reinterpret_cast<const float4*>(grow + ((c ^ (tid & 7)) << 2));
          acc += gv.x * ov[c].x;
          acc += gv.y * ov[c].y;
          acc += gv.z * ov[c].z;
          acc += gv.w * ov[c].w;
        }
        p.delta[vbase + t] = acc;
      }
      rowv[tid] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < T_len;
      lse_r[r] = in ? p.lse[vbase + row[r]] : 0.f;
      dl_r[r] = rowv[R + 8 * r];
      gl_r[r] = (in && p.glse != nullptr) ? p.glse[vbase + row[r]] : 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok_r[r] = row[r] < T_len && (mask == nullptr || mask[row[r]] > 0.f);
    }
  }
  const float* x0r = kept + R * 64;
  const float* x1r = kept + (kTRows + R) * 64;
  const int wr0 = r0 + 64 * wg;  // the warpgroup's first row
  float acc0[32], acc1[32];  // dQ; or dK and dV
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  for (int t = t_first; t < t_end; ++t) {
    const int st = (t - t_first) & 1, c0 = t * kTCols;
    split_rows(rawt, sb + tf_copy(0, 0), sb + tf_copy(0, 1), tid);
    split_rows(rawt + kTCols * 64, sb + tf_copy(1, 0), sb + tf_copy(1, 1), tid);
    split_t(rawt, sb + tf_copy(2, 0), sb + tf_copy(2, 1), tid);
    if constexpr (!DQ) split_t(rawt + kTCols * 64, sb + tf_copy(3, 0), sb + tf_copy(3, 1), tid);
    fence_async_smem();  // the halves, written by these threads, are read by wgmma
    __syncthreads();     // and the raw tile is free
    if (t + 1 < t_end) load_y(t + 1, st ^ 1);
    cp_async_commit();
    // a causal tile wholly past the warpgroup's rows (dq) or before its keys adds nothing
    const bool live = !p.causal || (DQ ? c0 <= wr0 + 63 : c0 + kTCols - 1 >= wr0);
    if (live) {
      float s[32], dp[32];
      product_xyt(s, x0r, base + tf_copy(0, 0), base + tf_copy(0, 1), g, t4);   // S = X0.Y0^T
      product_xyt(dp, x1r, base + tf_copy(1, 0), base + tf_copy(1, 1), g, t4);  // dP = X1.Y1^T
      tile_grads<DQ>(s, dp, vec + st * L::NV * kTCols, c0, t4, row, lse_r, dl_r, gl_r, ok_r, p);
      if constexpr (DQ) {
        product_xb(acc0, s, base + tf_copy(2, 0), base + tf_copy(2, 1));  // dQ += dS.K
      } else {
        product_xb(acc1, s, base + tf_copy(3, 0), base + tf_copy(3, 1));   // dV += P^T.dO
        product_xb(acc0, dp, base + tf_copy(2, 0), base + tf_copy(2, 1));  // dK += dS^T.Q
      }
    }
    cp_async_wait_all();  // the next raw tile has landed
    __syncthreads();      // and both warpgroups are done with the halves
  }
  if constexpr (DQ) {
    store_rows<float>(p.dq, acc0, p.scale, row, p, b, h, t4);
  } else {
    store_rows<float>(p.dk, acc0, p.scale, row, p, b, h, t4);
    store_rows<float>(p.dv, acc1, 1.f, row, p, b, h, t4);
  }
}

// ---------------------------------------------------------------------------
// bf16_wgmma
// ---------------------------------------------------------------------------

constexpr int kBRows = 64;               // rows a block keeps: one consumer warpgroup
constexpr int kBCols = 64;               // columns a swept tile holds
constexpr int kBThreads = 128 + 32;      // the consumers and one producer warp
constexpr uint32_t kBBox = 64 * 128;     // 64 rows x 64 bf16, 128-byte swizzle

template <int DP, bool DQ>
struct BfLayout {  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int NB = DP / 64;   // 64-feature boxes a tile
  static constexpr int S = 4;          // ring depth: TMA latency in flight
  static constexpr int NV = DQ ? 1 : 3;
  static constexpr uint32_t kept = 0;                     // [X0 boxes, X1 boxes]
  static constexpr uint32_t ring = 2 * NB * kBBox;        // [stage][Y0 boxes, Y1 boxes]
  static constexpr uint32_t stage_bytes = 2 * NB * kBBox;
  static constexpr uint32_t vec = ring + S * stage_bytes;  // [stage][NV][kBCols] f32
  static constexpr uint32_t rowv = vec + S * NV * kBCols * 4;  // [kBRows]: the dq pass's delta
  static constexpr uint32_t bars = rowv + kBRows * 4;      // kept, full[S], empty[S]
  static constexpr int bytes = bars + (1 + 2 * S) * 8 + 1024;  // + alignment slack
};

// One pass, as flash_bwd_tf32_wgmma_kernel's; maps over the views of X0,
// X1, Y0, Y1. Threads [0, 128) consume; thread 128's warp produces.
template <int DP, bool DQ>
__global__ void __launch_bounds__(kBThreads, 1)
    flash_bwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap x0map,
                                const __grid_constant__ CUtensorMap x1map,
                                const __grid_constant__ CUtensorMap y0map,
                                const __grid_constant__ CUtensorMap y1map, Params p) {
  using L = BfLayout<DP, DQ>;
  constexpr int NB = L::NB, NO = DP / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base = (raw_u + 1023u) & ~1023u;  // the swizzle pattern repeats every 1024 bytes
  unsigned char* sb = smem_raw + (base - raw_u);
  float* vec = reinterpret_cast<float*>(sb + L::vec);
  float* rowv = reinterpret_cast<float*>(sb + L::rowv);
  const uint32_t kbar = base + L::bars, full0 = kbar + 8, empty0 = full0 + 8 * L::S;
  if (threadIdx.x == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < L::S; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes, one with the copies' bytes
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int T_len = p.T, D = p.D;
  const int n_t = (T_len + kBCols - 1) / kBCols;
  const int n_rb = (T_len + kBRows - 1) / kBRows;
  const int r0 = (DQ ? n_rb - 1 - static_cast<int>(blockIdx.y) : static_cast<int>(blockIdx.y)) *
                 kBRows;  // longest first across all (b, h), as the f32 kernel's
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const long long vbase = static_cast<long long>(bh) * T_len;
  int t_first = 0, t_end = n_t;
  if (p.causal) {
    if (DQ) {
      t_end = min(n_t, (min(r0 + kBRows, T_len) - 1) / kBCols + 1);
    } else {
      t_first = r0 / kBCols;
    }
  }

  if (threadIdx.x >= 128) {
    // ---- producer: the kept rows once, then the swept tiles through the ring
    const int lane = threadIdx.x & 31;
    const float* mask =
        p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
    if (lane == 0) {
      mbar_arrive_tx(kbar, 2 * NB * kBBox);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        tma_load_4d(base + L::kept + i * kBBox, &x0map, kbar, 64 * i, h, r0, b);
        tma_load_4d(base + L::kept + (NB + i) * kBBox, &x1map, kbar, 64 * i, h, r0, b);
      }
    }
    for (int t = t_first; t < t_end; ++t) {
      const int it = t - t_first, s = it % L::S;
      mbar_wait(empty0 + 8 * s, ((it / L::S) & 1) ^ 1);
      float* vs = vec + s * L::NV * kBCols;
      for (int j = lane; j < kBCols; j += 32) {
        const int c = t * kBCols + j;
        const bool in = c < T_len;
        if constexpr (DQ) {
          vs[j] = (in && (mask == nullptr || mask[c] > 0.f)) ? 1.f : 0.f;
        } else {
          vs[j] = in ? p.lse[vbase + c] : 0.f;
          vs[kBCols + j] = in ? p.delta[vbase + c] : 0.f;
          vs[2 * kBCols + j] = (in && p.glse != nullptr) ? p.glse[vbase + c] : 0.f;
        }
      }
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        const uint32_t st = base + L::ring + s * L::stage_bytes;
        mbar_arrive_tx(full, L::stage_bytes);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          tma_load_4d(st + i * kBBox, &y0map, full, 64 * i, h, t * kBCols, b);
          tma_load_4d(st + (NB + i) * kBBox, &y1map, full, 64 * i, h, t * kBCols, b);
        }
      } else {
        mbar_arrive(full);  // after this lane's vector stores
      }
    }
    return;
  }

  // ---- consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int R = 16 * warp + g;
  const int row[2] = {r0 + R, r0 + R + 8};
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, gl_r[2] = {0.f, 0.f};
  bool ok_r[2] = {false, false};
  if constexpr (DQ) {
    // delta = rowsum(dO . O) in f32, in feature order, for the second pass
    // too: both rows in 16-byte loads issued together (D % 8 == 0)
    if (threadIdx.x < kBRows) {
      const int t = r0 + threadIdx.x;
      float acc = 0.f;
      if (t < T_len) {
        const long long at = ((static_cast<long long>(b) * T_len + t) * p.H + h) * D;
        const uint4* orow =
            reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.o) + at);
        const uint4* grow =
            reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.g) + at);
        uint4 ov[DP / 8], gv[DP / 8];
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          const bool in = 8 * c < D;
          ov[c] = in ? orow[c] : make_uint4(0u, 0u, 0u, 0u);
          gv[c] = in ? grow[c] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          const __nv_bfloat16* ob = reinterpret_cast<const __nv_bfloat16*>(&ov[c]);
          const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&gv[c]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc += to_f32(gb[e]) * to_f32(ob[e]);
        }
        p.delta[vbase + t] = acc;
      }
      rowv[threadIdx.x] = acc;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumers only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < T_len;
      lse_r[r] = in ? p.lse[vbase + row[r]] : 0.f;
      dl_r[r] = rowv[R + 8 * r];
      gl_r[r] = (in && p.glse != nullptr) ? p.glse[vbase + row[r]] : 0.f;
    }
  } else {
    const float* mask =
        p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ok_r[r] = row[r] < T_len && (mask == nullptr || mask[row[r]] > 0.f);
    }
  }
  float acc0[NO], acc1[NO];  // dQ; or dK and dV
#pragma unroll
  for (int i = 0; i < NO; ++i) acc0[i] = acc1[i] = 0.f;
  const uint32_t x0a = base + L::kept, x1a = x0a + NB * kBBox;
  mbar_wait(kbar, 0);

  for (int t = t_first; t < t_end; ++t) {
    const int it = t - t_first, s = it % L::S, c0 = t * kBCols;
    const uint32_t y0a = base + L::ring + s * L::stage_bytes, y1a = y0a + NB * kBBox;
    mbar_wait(full0 + 8 * s, (it / L::S) & 1);
    // S = X0.Y0^T, dP = X1.Y1^T: both K-major (128-byte rows, 8-row groups
    // 1024 bytes apart); a k16 step is 32 bytes along the row
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBBox + (kk & 3) * 32;
      wgmma_bf16_ss(sc, sw128_desc(x0a + off, 16, 1024), sw128_desc(y0a + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBBox + (kk & 3) * 32;
      wgmma_bf16_ss(dp, sw128_desc(x1a + off, 16, 1024), sw128_desc(y1a + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    // P and dS in f32, rounded to bf16 as they are packed below
    tile_grads<DQ>(sc, dp, vec + s * L::NV * kBCols, c0, t4, row, lse_r, dl_r, gl_r, ok_r, p);
    // P and dS rounded to bf16 A fragments (to nearest even, as the
    // contract's rounding): the 16 columns 16kk.. are the accumulator n-tiles
    // 2kk, 2kk + 1
    uint32_t xa[4][4], za[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        za[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    }
    // the last products: B MN-major (features contiguous), 64-feature boxes
    // kBBox apart, 8-row groups 1024 bytes apart; a k16 step is 2 KB
    wgmma_fence();
    if constexpr (DQ) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16_rs(acc0, xa[kk], sw128_desc(y0a + kk * 2048, kBBox, 1024));  // dQ += dS.K
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16_rs(acc1, xa[kk], sw128_desc(y1a + kk * 2048, kBBox, 1024));  // dV += P^T.dO
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16_rs(acc0, za[kk], sw128_desc(y0a + kk * 2048, kBBox, 1024));  // dK += dS^T.Q
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is free
  }
  if constexpr (DQ) {
    store_rows<__nv_bfloat16>(p.dq, acc0, p.scale, row, p, b, h, t4);
  } else {
    store_rows<__nv_bfloat16>(p.dk, acc0, p.scale, row, p, b, h, t4);
    store_rows<__nv_bfloat16>(p.dv, acc1, 1.f, row, p, b, h, t4);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda).
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
// boxes of 64 features x 1 head x 64 steps x 1 batch, 128-byte swizzle,
// zeros outside the view.
cudaError_t view_map(CUtensorMap* map, const void* ptr, long long sb, long long st, long long sh,
                     const Params& p) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.T), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
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

template <bool DQ>
cudaError_t launch_tf32(const Params& p, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_bwd_tf32_wgmma_kernel<DQ>;
  const cudaError_t err = allow_smem(kernel, TfLayout<DQ>::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + kTRows - 1) / kTRows);
  kernel<<<grid, kTThreads, TfLayout<DQ>::bytes, s>>>(p);
  return cudaGetLastError();
}

template <int DP, bool DQ>
cudaError_t launch_bf16(const Params& p, const CUtensorMap& x0, const CUtensorMap& x1,
                        const CUtensorMap& y0, const CUtensorMap& y1, cudaStream_t s) {
  static bool smem_set = false;
  auto kernel = flash_bwd_bf16_wgmma_kernel<DP, DQ>;
  const cudaError_t err = allow_smem(kernel, BfLayout<DP, DQ>::bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + kBRows - 1) / kBRows);
  kernel<<<grid, kBThreads, BfLayout<DP, DQ>::bytes, s>>>(x0, x1, y0, y1, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16_passes(const Params& p, int passes, cudaStream_t s) {
  CUtensorMap qm, km, vm, gm;
  cudaError_t err;
  const long long sd = static_cast<long long>(p.H) * p.D;  // dO: [B,T,H,D] contiguous
  if ((err = view_map(&qm, p.q, p.q_sb, p.q_st, p.q_sh, p)) != cudaSuccess) return err;
  if ((err = view_map(&km, p.k, p.k_sb, p.k_st, p.k_sh, p)) != cudaSuccess) return err;
  if ((err = view_map(&vm, p.v, p.v_sb, p.v_st, p.v_sh, p)) != cudaSuccess) return err;
  if ((err = view_map(&gm, p.g, sd * p.T, sd, p.D, p)) != cudaSuccess) return err;
  if (passes & kDqPass) {
    if ((err = launch_bf16<DP, true>(p, qm, gm, km, vm, s)) != cudaSuccess) return err;
  }
  if (passes & kDkDvPass) err = launch_bf16<DP, false>(p, km, vm, qm, gm, s);
  return err;
}

bool compiled(int variant, int dp) {
  return (variant == kF32Tf32x3Wgmma && dp == 64) ||
         (variant == kBf16Wgmma && (dp == 64 || dp == 128));
}

// the larger of the two passes' blocks (the dk/dv pass's: more swept copies or vectors)
int smem_bytes(int variant, int dp) {
  if (variant == kF32Tf32x3Wgmma) return TfLayout<false>::bytes;
  return dp == 64 ? BfLayout<64, false>::bytes : BfLayout<128, false>::bytes;
}

template <typename K>
cudaError_t occupancy_of(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <typename KQ, typename KK>
cudaError_t occupancy_pair(KQ dq, int dq_smem, KK dkdv, int dkdv_smem, int threads, int* blocks) {
  int a = 0, c = 0;
  cudaError_t err = occupancy_of(dq, threads, dq_smem, &a);
  if (err != cudaSuccess) return err;
  err = occupancy_of(dkdv, threads, dkdv_smem, &c);
  *blocks = a < c ? a : c;
  return err;
}

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// One flash backward on wgmma (the passes `passes` names, a Pass bit each:
// 3 for both, on `stream`): variant 3 f32_3xtf32_wgmma (dp 64: D <= 64;
// q, k, v, out, dO on 16 bytes; strides and D multiples of 4), 4 bf16_wgmma
// (dp 64 or 128; q, k, v, dO on 16 bytes, strides and D multiples of 8).
// Arguments as csrc/flash_attn_bwd.cu's flash_attn_bwd_launch. Returns the
// first cudaError_t met (0 on success); nothing is launched on a refusal.
extern "C" int flash_attn_bwd_wgmma_launch(int variant, int dp, int passes, const void* q,
                                           const void* k, const void* v, const void* o,
                                           const void* g, const void* lse, const void* glse,
                                           const void* mask, void* delta, void* dq, void* dk,
                                           void* dv, long long q_sb, long long q_st,
                                           long long q_sh, long long k_sb, long long k_st,
                                           long long k_sh, long long v_sb, long long v_st,
                                           long long v_sh, int B, int H, int T, int D,
                                           int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || T < 1 || D < 1 || D > dp || B * H > 65535 || !compiled(variant, dp) ||
      passes < 1 || passes > (kDqPass | kDkDvPass)) {
    return inval;
  }
  const long long strides[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const int elems = variant == kBf16Wgmma ? 8 : 4;  // 16 bytes
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(g) || D % elems != 0) return inval;
  if (variant == kF32Tf32x3Wgmma && !aligned(o)) return inval;
  for (long long st : strides) {
    if (st % elems != 0) return inval;
  }
  Params p{q, k, v, o, g,
           static_cast<const float*>(lse), static_cast<const float*>(glse),
           static_cast<const float*>(mask), static_cast<float*>(delta), dq, dk, dv,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           B, H, T, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kF32Tf32x3Wgmma) {
    if ((passes & kDqPass) && (err = launch_tf32<true>(p, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (passes & kDkDvPass) err = launch_tf32<false>(p, s);
  } else {
    err = dp == 64 ? launch_bf16_passes<64>(p, passes, s) : launch_bf16_passes<128>(p, passes, s);
  }
  return static_cast<int>(err);
}

// Shared memory (bytes) the larger block of the two passes takes, as
// plan_bwd() counts it; -1 for a configuration that is not compiled.
extern "C" int flash_attn_bwd_wgmma_smem_bytes(int variant, int dp) {
  return compiled(variant, dp) ? smem_bytes(variant, dp) : -1;
}

// Blocks of the configuration (the fewer of its two kernels) that fit on
// one SM of `device`, into *blocks.
extern "C" int flash_attn_bwd_wgmma_occupancy(int variant, int dp, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!compiled(variant, dp)) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kF32Tf32x3Wgmma) {
    err = occupancy_pair(flash_bwd_tf32_wgmma_kernel<true>, TfLayout<true>::bytes,
                         flash_bwd_tf32_wgmma_kernel<false>, TfLayout<false>::bytes, kTThreads,
                         blocks);
  } else if (dp == 64) {
    err = occupancy_pair(flash_bwd_bf16_wgmma_kernel<64, true>, BfLayout<64, true>::bytes,
                         flash_bwd_bf16_wgmma_kernel<64, false>, BfLayout<64, false>::bytes,
                         kBThreads, blocks);
  } else {
    err = occupancy_pair(flash_bwd_bf16_wgmma_kernel<128, true>, BfLayout<128, true>::bytes,
                         flash_bwd_bf16_wgmma_kernel<128, false>, BfLayout<128, false>::bytes,
                         kBThreads, blocks);
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attn_bwd_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel _attn_kernel of
// deeplearning4j_tpu/ops/attention_pallas.py (driven by _run_fwd).
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
// heads, or null.
//
// Layout: q, k, v are read in the JAX package's [B, T, H, D] order through
// element strides (batch, time, head; the feature axis is contiguous), so the
// views the fused QKV projection leaves behind are read in place, with no
// head-folding copy. out is written [B, T, H, D] contiguous, lse [B, H, T].
//
// What bounds it: at the training path's shape (B=4, H=8, T=4096, D=64,
// causal) the two products take 4*B*H*T^2*D/2 = 68.7 GFLOP against ~34 MB
// of q, k, v, out and lse in f32, so it is operation-bound: 1.03 ms on the
// CUDA cores' f32 rate, 0.07 ms on the bf16 tensor cores.
//
// Design (simple and right first; wgmma/TMA come later): the TPU's
// sequential key grid axis with VMEM scratch becomes a loop over key tiles
// inside one block that owns a query tile, so the running max, sum and
// accumulator live in registers for the whole sweep. One block of 256
// threads per (b*h, 64-row query tile): 32 x 64 = 2048 blocks at the path
// shape for 132 SMs. K and V tiles of 64 keys are staged in shared memory
// as f32 (bf16 operands widen exactly, so a bf16 x bf16 product summed in
// f32 is the tensor-core contract); each thread owns a 4 x 4 patch of the
// 64 x 64 score tile and the matching 4 rows x D/16 columns of the output,
// so the row statistics it rescales with are its own and a row's max and
// sum meet across the 16 lanes that share it by warp shuffles. The feature
// axis is templated (32, 64, 128; any D <= 128 rides the next size with a
// zero-filled tail). Causal key tiles wholly above the block's last row are
// never loaded. f32 math is full precision (expf, logf, no fast-math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 patch
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the PV product sees it: rounded to v's dtype (Pallas p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * (kBK + 1)) +
         sizeof(int) * kBK;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int kCols = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBQ][DP+1]
  float* ks = qs + kBQ * (DP + 1);          // [kBK][DP+1]
  float* vs = ks + kBK * (DP + 1);          // [kBK][DP]
  float* ps = vs + kBK * DP;                // [kBQ][kBK+1]
  int* kvalid = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));  // [kBK]

  const int T_len = p.T, D = p.D;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * T_len;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, t = q0 + r;
    qs[r * (DP + 1) + d] = (t < T_len && d < D) ? to_f(q[t * p.q_st + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (p.causal) {
    const int last_row = min(q0 + kBQ, T_len) - 1;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, t = k0 + r;
      const bool in = t < T_len && d < D;
      ks[r * (DP + 1) + d] = in ? to_f(k[t * p.k_st + d]) : 0.f;
      vs[r * DP + d] = in ? to_f(v[t * p.v_st + d]) : 0.f;
    }
    if (tid < kBK) {
      const int t = k0 + tid;
      kvalid[tid] = t < T_len && (mask == nullptr || mask[t] > 0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        valid[j] = kvalid[tx + 16 * j] && (!p.causal || col <= row);
        s[i][j] = valid[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of one row are a half warp: reduce within it
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // explicit zero: on a row with nothing valid yet m_new == s == -1e30
        // and exp(s - m_new) would be 1
        const float pij = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pij;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = round_to<T>(pij);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T_len) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const long long base = ((static_cast<long long>(b) * T_len + row) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[base + d] = from_f<T>(acc[i][c] / l_safe);
    }
    if (tx == 0) p.lse[(static_cast<long long>(bh)) * T_len + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int DP>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
        long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
        long long k_sh, long long v_sb, long long v_st, long long v_sh, int B, int H, int T_len,
        int D, int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || T_len < 1 || D < 1 || D > 128 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, static_cast<const float*>(mask), out, static_cast<float*>(lse),
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           B, H, T_len, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<T, 32>(p, s);
  if (D <= 64) return launch<T, 64>(p, s);
  return launch<T, 128>(p, s);
}

}  // namespace

// q, k, v [B,T,H,D] through element strides (batch, time, head; the feature
// axis contiguous), mask [B,T] f32 or null; out [B,T,H,D] contiguous in the
// input dtype, lse [B,H,T] f32. Returns the first cudaError_t met (0 on
// success).
extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* lse, long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                  long long v_sb, long long v_st, long long v_sh, int B, int H,
                                  int T, int D, int causal, float scale, int device,
                                  void* stream) {
  return run<float>(q, k, v, mask, out, lse, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                    v_sh, B, H, T, D, causal, scale, device, stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, void* lse, long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh, int B, int H,
                                   int T, int D, int causal, float scale, int device,
                                   void* stream) {
  return run<__nv_bfloat16>(q, k, v, mask, out, lse, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb,
                            v_st, v_sh, B, H, T, D, causal, scale, device, stream);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// LSTM sequence forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of deeplearning4j_tpu/ops/lstm_pallas.py:
// _lstm_seq_kernel (:91, resident Wh, H <= 512) and _lstm_seq_kernel_tiled
// (:132, Wh streamed in column tiles, H > 512), both behind the pallas_call
// of _fused_seq (:258, :270).
//
// Contract (lstm_pallas._fused_seq): for t in 0..T-1
//   z      = xz[t] + round(h_prev) . Wh          f32 accumulation
//   i, f   = sigmoid(z_i + wp0*c_prev), sigmoid(z_f + wp1*c_prev)
//   g      = tanh(z_g)
//   c      = f*c_prev + i*g
//   o      = sigmoid(z_o + wp2*c)                 peeps at the new, pre-mask c
//   h      = o*tanh(c)
//   h, c   = m*h + (1-m)*h_prev, m*c + (1-m)*c_prev   with m = mask[t, b]
// Gate order i|f|g|o along the 4H axis. round() casts the f32 state to Wh's
// dtype (bf16 operands meet in bf16). h and c are carried in f32; hs, cs, hT
// and cT are written in the input dtype, and the final h and c in f32 too (a
// caller carries those into its next call). wp and mask may be null.
//
// What bounds it on an H100 SXM: per step a [B,H] x [H,4H] product; over a
// sequence 2*T*B*H*4H operations against T*B*4H inputs read and 2*T*B*H
// outputs written, so at the served shapes (H=512, B up to 64) the bound is
// the CUDA cores' f32 rate: 2 us a step at B=64 (0.26 ms for T=128). The T
// steps are serial, and at small B a step is too little work to fill the
// card, so what a step costs besides its FMAs (the barrier between steps,
// bringing h_prev and Wh to the SMs) sets the time.
//
// Design (ops/lstm_seq.py plan() picks the variant and its grid; the C side
// checks and launches it):
//
// persistent: one cooperative launch runs all T steps. Block (x, y) owns 8
// hidden units j0 = 8x.. with all four gates (32 columns of Wh) for a group
// of 8*RT batch rows b0 = 8*RT*y.. (RT = 1, 2 or 4: the smallest whose grid
// fits one block on every SM), and keeps that Wh slice (every one of the H
// rows of K, widened to f32) in shared memory for the whole sequence: Wh
// is read from device memory once per call, not once per step. Each step
// each of the block's 8 warps copies its eighth of K of the block's rows of
// h_prev from L2 (cp.async.cg: L1 is not coherent across SMs, so h_prev
// never goes through it), rounds it to Wh's dtype, and takes that eighth of
// the product as soon as it has landed: a lane owns RT rows x 8
// columns (one gate of the 8 units) and runs 32 RT FMAs per float4 of h and
// two of Wh. At RT = 4 (32 rows a block, B > 32) the copy takes about as
// long as the product: it lands in four commit groups, and the product of
// each starts as soon as it has. The warps' partial sums meet in shared
// memory; thread (row, unit) finishes the gate math with c and h held in
// its registers across all T steps, writes h to the next of two f32 [B,H]
// buffers (h ping-pongs: every block reads all of h_prev) and the outputs,
// and the grid crosses into the next step through one barrier (an atomic
// counter in device memory, fence before the arrival, acquire loads while
// waiting). xz[t] and mask[t] load at the start of the step, in flight while
// h_prev lands and the product runs. bf16 products run on the CUDA cores as
// f32 FMAs of widened operands, which is exact. Measured on an H100 (see
// ops/ablation.py): at B=64 the barrier and the copy of h_prev (8 MB of L2
// reads a step over the grid) take ~1 us a step each, the step's own chain
// (FMAs, the warps' reduction, gate math) ~5 us; at B=1 that chain is
// ~2.9 us of ~4.
//
// step_cluster: shapes whose Wh slice and h rows cannot stay resident in one
// block on every SM (B above 64 at H=512, H=1024 from B=17; any H not a
// multiple of 4). The host issues T launches, one per step, so the launch
// boundary is the barrier. A block tile is 32 hidden units (one per lane,
// coalesced Wh and xz reads) by 8 batch rows with all four gate columns; the
// K axis is split across a thread-block cluster of `split` blocks and
// across the block's 8 warps, each warp streaming its rows of the Wh column
// slice from L2 against an h_prev tile in shared memory; warp partials meet
// in shared memory, cluster partials through distributed shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 32;                         // hidden units per block
constexpr int kWarps = 8;                          // split K inside a block
constexpr int kRows = 8;                           // batch rows per block
constexpr int kTileK = 256;                        // h_prev tile depth
constexpr int kThreads = kUnits * kWarps;
constexpr int kMaxSplit = 8;                       // portable cluster size
constexpr int kMinKPerBlock = 64;
static_assert(kWarps == kRows, "warp w reduces row w of the tile");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// step_cluster: one launch per step
// ---------------------------------------------------------------------------

// One step. Grid (ceil(H/32), ceil(B/8), split), cluster (1, 1, split):
// blockIdx.z (= the cluster rank) picks the K range [z*k_chunk, ...).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ xz_t, const T* __restrict__ wh,
                 const T* __restrict__ wp, const float* __restrict__ mask_t,
                 const float* __restrict__ h_prev, float* __restrict__ h_next,
                 float* __restrict__ c_state, T* __restrict__ hs_t,
                 T* __restrict__ cs_t, T* __restrict__ h_last,
                 T* __restrict__ c_last, int B, int H, int k_chunk) {
  __shared__ float s_h[kRows][kTileK];
  __shared__ float s_red[kWarps][4][kRows][kUnits];
  __shared__ float s_part[4][kRows][kUnits];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kUnits + lane;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int j = j0 + lane;
  const bool j_ok = j < H;
  const size_t h4 = 4 * static_cast<size_t>(H);
  const int kbeg = rank * k_chunk;
  const int kend = min(H, kbeg + k_chunk);
  // this thread finishes (row b0 + warp, unit j) when its rank owns the row
  const int b = b0 + warp;
  const bool finisher = warp % split == rank && j_ok && b < B;

  // this step's xz slice and the peepholes load while the product runs
  float x_in[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  if (finisher) {
    const T* xr = xz_t + static_cast<size_t>(b) * h4;
#pragma unroll
    for (int g = 0; g < 4; ++g) x_in[g] = to_f32(xr[static_cast<size_t>(g) * H + j]);
    if (wp != nullptr) {
      p_i = to_f32(wp[j]);
      p_f = to_f32(wp[H + j]);
      p_o = to_f32(wp[2 * H + j]);
    }
  }

  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += kTileK) {
    const int n = min(kTileK, kend - k0);
    for (int idx = tid; idx < kRows * kTileK; idx += kThreads) {
      const int r = idx / kTileK;
      const int kk = idx % kTileK;
      const int row_b = b0 + r;
      // h_prev meets Wh in Wh's dtype (lstm_pallas.py:114-116)
      s_h[r][kk] = (row_b < B && kk < n)
          ? to_f32(from_f32<T>(h_prev[static_cast<size_t>(row_b) * H + k0 + kk]))
          : 0.0f;
    }
    __syncthreads();
    const int per = (n + kWarps - 1) / kWarps;
    const int lo = warp * per;
    const int hi = min(n, lo + per);
#pragma unroll 4
    for (int kk = lo; kk < hi; ++kk) {
      const T* row = wh + static_cast<size_t>(k0 + kk) * h4 + j;
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = j_ok ? to_f32(row[static_cast<size_t>(g) * H]) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = s_h[r][kk];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, w[g], acc[g][r]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) s_red[warp][g][r][lane] = acc[g][r];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[w][g][warp][lane];
    s_part[g][warp][lane] = sum;
  }
  cluster.sync();  // every rank's partials are visible cluster-wide

  if (finisher) {
    float z[4] = {x_in[0], x_in[1], x_in[2], x_in[3]};
    for (int q = 0; q < split; ++q) {
      const float* part = cluster.map_shared_rank(&s_part[0][0][0], q);
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] += part[(g * kRows + warp) * kUnits + lane];
    }
    const size_t at = static_cast<size_t>(b) * H + j;
    const float c_prev = c_state[at];
    const float ig = sigmoid(z[0] + p_i * c_prev);
    const float fg = sigmoid(z[1] + p_f * c_prev);
    const float gg = tanhf(z[2]);
    float c = fg * c_prev + ig * gg;
    const float og = sigmoid(z[3] + p_o * c);
    float h = og * tanhf(c);
    if (mask_t != nullptr) {
      const float m = mask_t[b];
      h = m * h + (1.0f - m) * h_prev[at];
      c = m * c + (1.0f - m) * c_prev;
    }
    h_next[at] = h;
    c_state[at] = c;
    hs_t[at] = from_f32<T>(h);
    cs_t[at] = from_f32<T>(c);
    if (h_last != nullptr) {
      h_last[at] = from_f32<T>(h);
      c_last[at] = from_f32<T>(c);
    }
  }
  cluster.sync();  // keep this block's s_part alive until all ranks read it
}

// Cluster size along K: double it while the grid stays within two blocks
// per SM and each block keeps at least kMinKPerBlock rows of Wh.
int choose_split(int B, int H, int sms) {
  const int tiles = ((H + kUnits - 1) / kUnits) * ((B + kRows - 1) / kRows);
  int split = 1;
  while (split < kMaxSplit && tiles * split * 2 <= 2 * sms &&
         H / (split * 2) >= kMinKPerBlock) {
    split *= 2;
  }
  return split;
}


// ---------------------------------------------------------------------------
// persistent: one cooperative launch, Wh resident in shared memory
// ---------------------------------------------------------------------------

enum Variant { kPersistent = 0, kStepCluster = 1 };

constexpr int kPUnits = 8;                 // hidden units per block
constexpr int kPCols = 4 * kPUnits;        // their Wh columns, gate-major
constexpr int kPWarps = 8;                 // split K inside a block
constexpr int kPThreads = 32 * kPWarps;
constexpr int kRedLd = 40;                 // partials row stride (floats): conflict-free reads


struct SeqParams {
  const void* xz;
  const void* wh;
  const void* wp;
  const float* mask;
  void* hs;
  void* cs;
  void* h_last;
  void* c_last;
  float* h_buf;       // [2][B][H] f32, h0 in the first half; the final h in half T % 2
  float* c_state;     // [B][H] f32: c0 in, the final c out
  unsigned* sync;     // the grid barrier's counter, zeroed before the launch
  int T, B, H, KP, kc;  // KP = 8 kc >= H: K padded to whole float4 steps per warp
};

// Bytes of shared memory of one persistent block: Wh slice [KP][32], h rows
// [8 RT][KP + 4], partials [8 warps][8 RT][kRedLd], all f32.
constexpr int persistent_smem(int rt, int kp) {
  return 4 * (kp * kPCols + 8 * rt * (kp + 4) + kPWarps * 8 * rt * kRedLd);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared through L2 only; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Every block of the grid arrives, then waits until all have: `target`
// counts the arrivals this block has waited for so far.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned blocks, unsigned& target) {
  __syncthreads();  // the block's writes of this step are done
  target += blocks;
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible device-wide before the arrival
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until commit groups 0..ch of NCH (1 or 4) have landed.
template <int NCH>
__device__ __forceinline__ void wait_chunk(int ch) {
  static_assert(NCH == 1 || NCH == 4, "one or four commit groups");
  if constexpr (NCH == 1) {
    cp_async_wait<0>();
  } else {
    if (ch == 0) cp_async_wait<3>();
    if (ch == 1) cp_async_wait<2>();
    if (ch == 2) cp_async_wait<1>();
    if (ch == 3) cp_async_wait<0>();
  }
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid (ceil(H/8), ceil(B/(8 RT))), kPThreads threads. Lane l of warp w
// owns rows (l/4) + 8i (i < RT) of the block's batch group and columns
// 8(l%4)..+7 (gate l%4 of the 8 units) over K rows [w kc, (w+1) kc);
// thread (r, u) = (tid / 8, tid % 8) owns unit j0 + u of row b0 + r.
template <typename T, int RT>
__global__ void __launch_bounds__(kPThreads, 1) lstm_persistent_kernel(SeqParams p) {
  constexpr int RB = 8 * RT;
  extern __shared__ __align__(16) float sm[];
  const int KP = p.KP, S = KP + 4;  // S = 4 (mod 32): the 8 row tiles' float4s hit distinct banks
  float* w_s = sm;                  // [KP][kPCols]
  float* h_s = w_s + KP * kPCols;   // [RB][S]
  float* red = h_s + RB * S;        // [kPWarps][RB][kRedLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = lane >> 2, ct = lane & 3;
  const int H = p.H, B = p.B;
  const int j0 = blockIdx.x * kPUnits, b0 = blockIdx.y * RB;
  const size_t h4 = 4 * static_cast<size_t>(H);
  const size_t bh = static_cast<size_t>(B) * H;

  // the Wh slice, once: w_s[k][g*8 + u] = Wh[k, g*H + j0 + u], zeros past H
  const T* wh = static_cast<const T*>(p.wh);
  for (int idx = tid; idx < KP * kPCols; idx += kPThreads) {
    const int k = idx / kPCols, col = idx - k * kPCols;
    const int g = col / kPUnits, j = j0 + col % kPUnits;
    w_s[idx] = (k < H && j < H) ? to_f32(wh[k * h4 + static_cast<size_t>(g) * H + j]) : 0.0f;
  }
  __syncthreads();  // a warp's K rows of the slice were filled by every thread

  const int gr = tid / kPUnits, gu = tid % kPUnits;
  const int b = b0 + gr, j = j0 + gu;
  const bool mine = tid < RB * kPUnits && b < B && j < H;
  const size_t at = static_cast<size_t>(b) * H + j;
  float c = 0.0f, h = 0.0f, p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  if (mine) {
    c = p.c_state[at];
    h = p.h_buf[at];
    if (p.wp != nullptr) {
      const T* wp = static_cast<const T*>(p.wp);
      p_i = to_f32(wp[j]);
      p_f = to_f32(wp[H + j]);
      p_o = to_f32(wp[2 * H + j]);
    }
  }
  const T* xz = static_cast<const T*>(p.xz);
  T* hs = static_cast<T*>(p.hs);
  T* cs = static_cast<T*>(p.cs);
  const int kbeg = warp * p.kc, kq = p.kc / 4;
  // the warp's h_prev slice lands in NCH commit groups (four at 32 rows a
  // block, where the copies take as long as the product; else one)
  constexpr int NCH = RT == 4 ? 4 : 1;
  const unsigned blocks = gridDim.x * gridDim.y;
  unsigned target = 0;

  for (int t = 0; t < p.T; ++t) {
    const float* h_prev = p.h_buf + (t & 1) * bh;
    float* h_next = p.h_buf + ((t + 1) & 1) * bh;
    // this step's xz and mask do not depend on h: in flight during the product
    float x_in[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float mt = 1.0f;
    if (mine) {
      const T* xr = xz + (static_cast<size_t>(t) * B + b) * h4;
#pragma unroll
      for (int g = 0; g < 4; ++g) x_in[g] = to_f32(xr[static_cast<size_t>(g) * H + j]);
      if (p.mask != nullptr) mt = p.mask[static_cast<size_t>(t) * B + b];
    }
    // this warp's K slice of h_prev rows b0.., through L2, zeros past B and
    // H, in NCH commit groups: the product of a group starts as soon as it
    // has landed, while the later ones are in flight
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int q0 = kq * ch / NCH, nq = kq * (ch + 1) / NCH - q0;
      for (int idx = lane; idx < RB * nq; idx += 32) {
        const int r = idx / nq, k = kbeg + (q0 + idx - r * nq) * 4, bb = b0 + r;
        const bool ok = bb < B && k < H;
        cp_async16(smem_u32(h_s + r * S + k),
                   ok ? h_prev + static_cast<size_t>(bb) * H + k : h_prev, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      wait_chunk<NCH>(ch);
      const int q0 = kq * ch / NCH, nq = kq * (ch + 1) / NCH - q0;
      if constexpr (!std::is_same<T, float>::value) {
        // h meets Wh in Wh's dtype (lstm_pallas.py:114-116); each lane its own copies
        for (int idx = lane; idx < RB * nq; idx += 32) {
          const int r = idx / nq, k = kbeg + (q0 + idx - r * nq) * 4;
          float4* v = reinterpret_cast<float4*>(h_s + r * S + k);
          float4 x = *v;
          x.x = to_f32(from_f32<T>(x.x));
          x.y = to_f32(from_f32<T>(x.y));
          x.z = to_f32(from_f32<T>(x.z));
          x.w = to_f32(from_f32<T>(x.w));
          *v = x;
        }
      }
      __syncwarp();
      const int k_lo = kbeg + 4 * q0, k_hi = k_lo + 4 * nq;
#pragma unroll 2
      for (int k = k_lo; k < k_hi; k += 4) {
        float4 hv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          hv[i] = *reinterpret_cast<const float4*>(h_s + (rt + 8 * i) * S + k);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w0 = *reinterpret_cast<const float4*>(w_s + (k + kk) * kPCols + 8 * ct);
          const float4 w1 =
              *reinterpret_cast<const float4*>(w_s + (k + kk) * kPCols + 8 * ct + 4);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float x = pick(hv[i], kk);
            acc[i][0] = fmaf(x, w0.x, acc[i][0]);
            acc[i][1] = fmaf(x, w0.y, acc[i][1]);
            acc[i][2] = fmaf(x, w0.z, acc[i][2]);
            acc[i][3] = fmaf(x, w0.w, acc[i][3]);
            acc[i][4] = fmaf(x, w1.x, acc[i][4]);
            acc[i][5] = fmaf(x, w1.y, acc[i][5]);
            acc[i][6] = fmaf(x, w1.z, acc[i][6]);
            acc[i][7] = fmaf(x, w1.w, acc[i][7]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* dst = red + (warp * RB + rt + 8 * i) * kRedLd + 8 * ct;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

    if (mine) {
      float z[4] = {x_in[0], x_in[1], x_in[2], x_in[3]};
#pragma unroll
      for (int w = 0; w < kPWarps; ++w) {
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] += red[(w * RB + gr) * kRedLd + g * kPUnits + gu];
      }
      const float ig = sigmoid(z[0] + p_i * c);
      const float fg = sigmoid(z[1] + p_f * c);
      const float gg = tanhf(z[2]);
      float c_new = fg * c + ig * gg;
      const float og = sigmoid(z[3] + p_o * c_new);
      float h_new = og * tanhf(c_new);
      if (p.mask != nullptr) {
        h_new = mt * h_new + (1.0f - mt) * h;
        c_new = mt * c_new + (1.0f - mt) * c;
      }
      h = h_new;
      c = c_new;
      h_next[at] = h;
      const size_t out = static_cast<size_t>(t) * bh + at;
      hs[out] = from_f32<T>(h);
      cs[out] = from_f32<T>(c);
      if (t == p.T - 1) {
        static_cast<T*>(p.h_last)[at] = from_f32<T>(h);
        static_cast<T*>(p.c_last)[at] = from_f32<T>(c);
        p.c_state[at] = c;  // the f32 state a caller carries on (h is in h_next)
      }
    }
    if (t + 1 < p.T) grid_barrier(p.sync, blocks, target);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int RT>
cudaError_t launch_persistent(const SeqParams& p, int groups, cudaStream_t s) {
  auto kernel = lstm_persistent_kernel<T, RT>;
  const int smem = persistent_smem(RT, p.KP);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(p.sync, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.H + kPUnits - 1) / kPUnits, groups);
  cfg.blockDim = dim3(kPThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block co-resident, or a refused launch
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_persistent(const SeqParams& p, int rt, int groups, cudaStream_t s) {
  if (rt == 1) return launch_persistent<T, 1>(p, groups, s);
  if (rt == 2) return launch_persistent<T, 2>(p, groups, s);
  return launch_persistent<T, 4>(p, groups, s);
}

template <typename T>
cudaError_t run_step(const void* xz, const void* wh, const void* wp, const void* mask, void* hs,
                     void* cs, void* h_last, void* c_last, void* h_state, void* c_state,
                     int steps, int B, int H, int split, cudaStream_t stream) {
  const int k_chunk = (H + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows, split);
  cfg.blockDim = dim3(kUnits, kWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const size_t in_step = static_cast<size_t>(B) * 4 * H;
  const size_t out_step = static_cast<size_t>(B) * H;
  const T* xz_p = static_cast<const T*>(xz);
  const float* mask_p = static_cast<const float*>(mask);
  float* h_buf = static_cast<float*>(h_state);
  T* hs_p = static_cast<T*>(hs);
  T* cs_p = static_cast<T*>(cs);
  for (int t = 0; t < steps; ++t) {
    const bool last = t == steps - 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, lstm_step_kernel<T>, xz_p + t * in_step, static_cast<const T*>(wh),
        static_cast<const T*>(wp),
        mask_p == nullptr ? nullptr : mask_p + static_cast<size_t>(t) * B,
        static_cast<const float*>(h_buf + (t & 1) * out_step),
        h_buf + ((t + 1) & 1) * out_step, static_cast<float*>(c_state),
        hs_p + t * out_step, cs_p + t * out_step,
        last ? static_cast<T*>(h_last) : nullptr,
        last ? static_cast<T*>(c_last) : nullptr, B, H, k_chunk);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run(int variant, int rt, int split, const void* xz, const void* wh, const void* wp,
                const void* mask, void* hs, void* cs, void* h_last, void* c_last, void* h_state,
                void* c_state, void* sync, int steps, int B, int H, cudaStream_t s) {
  if (variant == kStepCluster) {
    return run_step<T>(xz, wh, wp, mask, hs, cs, h_last, c_last, h_state, c_state, steps, B, H,
                       split, s);
  }
  const int kc = ((H / 4 + kPWarps - 1) / kPWarps) * 4;
  SeqParams p{xz, wh, wp, static_cast<const float*>(mask), hs, cs, h_last, c_last,
              static_cast<float*>(h_state), static_cast<float*>(c_state),
              static_cast<unsigned*>(sync), steps, B, H, kPWarps * kc, kc};
  const int groups = (B + 8 * rt - 1) / (8 * rt);
  return dispatch_persistent<T>(p, rt, groups, s);
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

}  // namespace

// One lstm_seq call on the plan of ops/lstm_seq.py: variant 0 (persistent,
// rows per lane `rt` in 1, 2, 4; H % 4 == 0; its grid must fit the card)
// or 1 (step_cluster, cluster size `split` in 1, 2, 4, 8). xz [T,B,4H], wh
// [H,4H], wp [3,H] or null, f32 or bf16 (`bf16` 0 or 1); mask [T,B] f32 or
// null; hs, cs [T,B,H] and h_last, c_last [B,H] in that dtype; h_state
// [2,B,H] f32 with h0 in its first half; c_state [B,H] f32 holding c0; both
// variants leave the final f32 h in h_state[T % 2] and the final f32 c in
// c_state; sync one 4-byte word of scratch.
// Returns the first cudaError_t met (0 on success); nothing is launched on
// a refusal.
extern "C" int lstm_seq_launch(int variant, int rt, int split, int bf16, const void* xz,
                               const void* wh, const void* wp, const void* mask, void* hs,
                               void* cs, void* h_last, void* c_last, void* h_state,
                               void* c_state, void* sync, int steps, int B, int H, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (steps < 1 || B < 1 || H < 1) return inval;
  if (variant == kPersistent) {
    if ((rt != 1 && rt != 2 && rt != 4) || H % 4 != 0 || sync == nullptr) return inval;
  } else if (variant == kStepCluster) {
    if (split != 1 && split != 2 && split != 4 && split != 8) return inval;
  } else {
    return inval;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? run<__nv_bfloat16>(variant, rt, split, xz, wh, wp, mask, hs, cs, h_last, c_last,
                                  h_state, c_state, sync, steps, B, H, s)
             : run<float>(variant, rt, split, xz, wh, wp, mask, hs, cs, h_last, c_last, h_state,
                          c_state, sync, steps, B, H, s);
  return static_cast<int>(err);
}

// Shared memory (bytes) of one persistent block at rows per lane `rt` and
// width H, as plan() counts it.
extern "C" int lstm_seq_smem_bytes(int rt, int H) {
  const int kc = ((H / 4 + kPWarps - 1) / kPWarps) * 4;
  return persistent_smem(rt, kPWarps * kc);
}

// Persistent blocks at (rt, H, dtype) that fit on one SM of `device`, into
// *blocks.
extern "C" int lstm_seq_occupancy(int rt, int H, int bf16, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = lstm_seq_smem_bytes(rt, H);
  if (rt != 1 && rt != 2 && rt != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    err = rt == 1 ? occupancy_of(lstm_persistent_kernel<__nv_bfloat16, 1>, kPThreads, smem, blocks)
        : rt == 2 ? occupancy_of(lstm_persistent_kernel<__nv_bfloat16, 2>, kPThreads, smem, blocks)
                  : occupancy_of(lstm_persistent_kernel<__nv_bfloat16, 4>, kPThreads, smem, blocks);
  } else {
    err = rt == 1 ? occupancy_of(lstm_persistent_kernel<float, 1>, kPThreads, smem, blocks)
        : rt == 2 ? occupancy_of(lstm_persistent_kernel<float, 2>, kPThreads, smem, blocks)
                  : occupancy_of(lstm_persistent_kernel<float, 4>, kPThreads, smem, blocks);
  }
  return static_cast<int>(err);
}

// The cluster size step_cluster takes for this shape on ``device`` (0 when
// the device cannot be queried).
extern "C" int lstm_seq_split(int B, int H, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return choose_split(B, H, sms);
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// LSTM sequence forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of deeplearning4j_tpu/ops/lstm_pallas.py:
// _lstm_seq_kernel (resident Wh, H <= 512) and _lstm_seq_kernel_tiled (Wh
// streamed in column tiles, H > 512). One kernel covers any H and any B.
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
// and cT are written in the input dtype. wp and mask may be null.
//
// What bounds it: per step a [B,H] x [H,4H] product; over a sequence
// 2*T*B*H*4H operations against T*B*4H inputs read and 2*T*B*H outputs
// written, so at the served shapes (H=512, B=64) the bound is the f32
// operation rate of the CUDA cores. The T serial steps each depend on the
// one before, and at small B one step is too little work to fill the card,
// so in practice per-step latency (launch, L2 round trips, the barrier
// between steps) sets the time.
//
// Design (simple and right first): the host issues T launches on the
// caller's stream, one per step, so the launch boundary is the grid-wide
// barrier between steps. h ping-pongs between two f32 [B,H] buffers because
// every block reads all of h_prev; c is updated in place. A block tile is
// 32 hidden units (one per lane, so Wh and xz reads are coalesced along the
// unit axis) by 8 batch rows, with all four gate columns of its units, so
// the gate math needs nothing from outside the tile. The K (hidden) axis of
// the product is split twice: across a thread-block cluster of up to 8
// blocks (more blocks in flight when B is small; chosen from B, H and the
// SM count), and within a block across its 8 warps. Each warp streams its
// rows of the Wh column slice straight from L2 (Wh, 4 MB at H=512 in f32,
// stays resident there across steps) against an h_prev tile in shared
// memory. Warp partials meet in shared memory, cluster partials through
// distributed shared memory, and each cluster rank finishes the gate math
// for a share of the tile's rows. A persistent kernel with a grid-wide
// barrier, and tensor-core products, are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T>
int run(const void* xz, const void* wh, const void* wp, const void* mask,
        void* hs, void* cs, void* h_last, void* c_last, void* h_state,
        void* c_state, int steps, int B, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = choose_split(B, H, sms);
  const int k_chunk = (H + split - 1) / split;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows, split);
  cfg.blockDim = dim3(kUnits, kWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
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
    err = cudaLaunchKernelEx(
        &cfg, lstm_step_kernel<T>, xz_p + t * in_step, static_cast<const T*>(wh),
        static_cast<const T*>(wp),
        mask_p == nullptr ? nullptr : mask_p + static_cast<size_t>(t) * B,
        static_cast<const float*>(h_buf + (t & 1) * out_step),
        h_buf + ((t + 1) & 1) * out_step, static_cast<float*>(c_state),
        hs_p + t * out_step, cs_p + t * out_step,
        last ? static_cast<T*>(h_last) : nullptr,
        last ? static_cast<T*>(c_last) : nullptr, B, H, k_chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// xz [T,B,4H], wh [H,4H], wp [3,H] or null, mask [T,B] f32 or null; hs, cs
// [T,B,H] and h_last, c_last [B,H] in the input dtype; h_state [2,B,H] f32
// with h0 in its first half; c_state [B,H] f32 holding c0, updated in place.
// Returns the first cudaError_t met (0 on success).
extern "C" int lstm_seq_f32(const void* xz, const void* wh, const void* wp,
                            const void* mask, void* hs, void* cs, void* h_last,
                            void* c_last, void* h_state, void* c_state, int steps,
                            int B, int H, int device, void* stream) {
  return run<float>(xz, wh, wp, mask, hs, cs, h_last, c_last, h_state, c_state,
                    steps, B, H, device, stream);
}

extern "C" int lstm_seq_bf16(const void* xz, const void* wh, const void* wp,
                             const void* mask, void* hs, void* cs, void* h_last,
                             void* c_last, void* h_state, void* c_state, int steps,
                             int B, int H, int device, void* stream) {
  return run<__nv_bfloat16>(xz, wh, wp, mask, hs, cs, h_last, c_last, h_state,
                            c_state, steps, B, H, device, stream);
}

// The cluster size the kernel uses for this shape on ``device`` (0 when the
// device cannot be queried).
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

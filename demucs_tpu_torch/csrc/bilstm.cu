// BiLSTM recurrence (K6) for Hopper (sm_90a): a thread-block-cluster kernel.
//
// Replaces the Pallas TPU kernel demucs_tpu/ops/pallas/lstm.py:
// bilstm_recurrence (_bilstm_kernel): both directions of one BiLSTM
// layer's recurrence in one launch. From
//   xs   (T, 2, B, 4H): the input projections plus both biases,
//        direction 1 already time-flipped,
//   w_hh (2, H, 4H)   : the recurrent weights, transposed,
// it writes ys (T, 2, B, H) (direction 1 still flipped), all three f32
// (bilstm_recurrence_f32) or all bf16 (bilstm_recurrence_bf16). h and c
// start at zero; per step and direction
//   gates = xs[t, d] + h @ w_hh[d]            (gate order i, f, g, o)
//   c = sigmoid(f) c + sigmoid(i) tanh(g),    h = sigmoid(o) tanh(c)
// in f32 with expf and tanhf (no fast-math intrinsics). As in the TPU
// kernel, the bf16 form keeps the gates (summed in f32 from exact bf16
// products), c and the nonlinearities in f32 and rounds h to bf16 (to
// nearest even) each step: that h is what ys holds and what the next
// step's product reads.
//
// What bounds it: the work is small (16 T B H^2 flops, 0.4-0.8 GFLOP at
// the Demucs shapes, ~10 us at the f32 peak) and so are the bytes (xs,
// w_hh and ys once, 6-10 MB, ~3 us at HBM speed). What no form avoids is
// the chain of T dependent steps: each needs all of h from the step
// before, so each ends in a barrier across everything that computes h.
// The TPU kernel keeps both w_hh resident in VMEM for the whole scan. One
// direction's w_hh (590 KB at H=192, 2.36 MB at H=384) does not fit one
// SM's 227 KB of shared memory, so the first form of this kernel (one
// block per direction, w_hh streamed from L2 every step) was bound by one
// SM's L2 bandwidth and latency: 13-30 us per step.
//
// Design: one thread-block cluster per direction and group of NB batch
// rows (NB = 1, 2, 4 or 8: B rounded up to a power of two, at most 8), so
// the grid is (cs, 2, ceil(B / NB)) with clusters of cs blocks along x:
//   * cs = 16 (a non-portable cluster size, allowed by attribute and
//     checked with cudaOccupancyMaxActiveClusters before the first launch
//     at each hidden size), or 8 where 16 cannot be placed;
//   * block r of a cluster owns hidden units [r U, r U + U), U =
//     ceil(H / cs), and holds the 4U gate columns of w_hh[d] for them in
//     shared memory for the whole scan, in w_hh's own type, column-major
//     with a row pitch of 4 mod 8 elements, so a warp's reads of 4
//     elements of 32 columns (16 bytes in f32, 8 in bf16) are free of bank
//     conflicts: 384 x 96 x 4 B = 147 KB at H=384 and cs=16 in f32, half
//     that in bf16, 37 KB at H=192 in f32. Rows of the slice that do not
//     fit (H=512, or cs=8 at H=384 in f32) are read from L2 every step
//     instead;
//   * thread (column c, k slice s) sums h[k] w[k][c] over its slice of k
//     for the NB rows, four k at a time (one float4 of w, one broadcast
//     float4 of h per row); the slices' partial sums meet in shared
//     memory and thread (unit u, row b) adds them, in slice order, to
//     xs, applies the gates and keeps its cell state c in a register;
//   * h is exchanged through distributed shared memory: each block keeps
//     all of h (NB x H) double-buffered, and the thread that computes
//     h[b][j] stores it into the next buffer of every block of the
//     cluster (cluster.map_shared_rank); one cluster barrier per step
//     (barrier.cluster.arrive.release / wait.acquire) orders step t's
//     stores before step t+1's reads, and the double buffer means no
//     block can overwrite what another still reads;
//   * xs[t + 1] is prefetched while step t computes: it does not depend
//     on h. In f32 with cp.async into a double buffer in shared memory
//     (each thread copies exactly the four gate inputs it will read, so
//     the copy needs only that thread's cp.async.wait_group); in bf16
//     (cp.async copies no 2-byte element) into the thread's registers;
//   * rows past B and units past H compute on zeros and are not stored
//     (their h stays 0, so they add nothing to the other units' gates).
// A step thus costs one pass over a block's shared slice of w_hh, a
// partial-sum exchange inside the block, cs stores of each h value into
// the cluster's shared memory and one cluster barrier.
//
// cluster_floor_kernel is not part of the model: it runs K6's grid,
// cluster and shared memory at the same shape, and T steps of nothing but
// the DSMEM exchange of h and the cluster barrier: the sequential floor of
// this form. block_floor_kernel is the floor of the first form (one block
// per direction and pair of rows, T steps of __syncthreads), kept for the
// comparison.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the launch set-up).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 512;
constexpr int kMaxRows = 8;          // batch rows per cluster
constexpr int kMaxThreads = 512;     // per block
constexpr int kSmemLimit = 232448;   // 227 KB of shared memory per block
constexpr int kClusterSizes[] = {16, 8};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all of this thread's cp.async groups but the newest one have landed
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// an f32 value as T: itself, or rounded to the nearest even bf16
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements of shared w (4-element aligned) as f32
__device__ __forceinline__ float4 load_w4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half of u.x
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// NB: the batch rounded up to a power of two, at most kMaxRows
int rows_for(int batch) {
  int rows = 1;
  while (rows < batch && rows < kMaxRows) rows *= 2;
  return rows;
}

// How one launch cuts the work; computed on the host, passed by value.
struct Plan {
  int cs;       // blocks per cluster
  int units;    // U: hidden units per block
  int cols;     // 4U gate columns per block
  int rows;     // NB: batch rows per cluster
  int groups;   // clusters per direction
  int ktot;     // H rounded up to 4
  int kchunk;   // k per slice, a multiple of 4
  int kslices;  // slices of k per column
  int kres;     // rows of the w slice held in shared memory (a multiple of 4)
  int kpitch;   // elements between two columns of the shared w slice (4 mod 8)
  int hpitch;   // floats per row of a shared h buffer (cs U rounded up to 4)
  int threads;  // per block
  int bytes;    // dynamic shared memory per block
};

// esize: bytes of an element of w_hh (4: f32, 2: bf16); everything else in
// shared memory is f32
Plan make_plan(int hidden, int batch, int cs, int esize) {
  Plan p;
  p.cs = cs;
  p.units = (hidden + cs - 1) / cs;
  p.cols = 4 * p.units;
  p.rows = rows_for(batch);
  p.groups = (batch + p.rows - 1) / p.rows;
  p.ktot = round_up(hidden, 4);
  const int want = std::max(1, std::min(kMaxThreads / p.cols, p.ktot / 4));
  p.kchunk = round_up((p.ktot + want - 1) / want, 4);
  p.kslices = (p.ktot + p.kchunk - 1) / p.kchunk;
  p.hpitch = round_up(cs * p.units, 4);
  p.threads = round_up(std::max(p.kslices * p.cols, p.units * p.rows), 32);
  const int other = 4 * (2 * p.rows * p.hpitch            // h, double-buffered
                         + p.kslices * p.rows * p.cols    // partial sums
                         + 2 * p.rows * p.cols);          // xs, double-buffered (f32)
  p.kres = p.ktot;
  auto pitch = [](int k) { return k ? round_up(k, 8) + 4 : 0; };
  while (p.kres > 0 && other + esize * p.cols * pitch(p.kres) > kSmemLimit) p.kres -= 4;
  p.kpitch = pitch(p.kres);
  p.bytes = other + esize * p.cols * p.kpitch;
  return p;
}

template <typename T, int NB>
__global__ void __launch_bounds__(kMaxThreads, 1)
bilstm_cluster_kernel(const T* __restrict__ xs, const T* __restrict__ w_hh,
                      T* __restrict__ ys, int t_len, int batch, int hidden, const Plan p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int H = hidden, U = p.units, C = p.cols;
  const size_t H4 = 4 * (size_t)H;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * NB;
  const int tid = threadIdx.x;
  T* w_s = reinterpret_cast<T*>(smem4);                      // [C][kpitch], k < kres
  float* h_s = reinterpret_cast<float*>(w_s + C * p.kpitch);  // [2][NB][hpitch]
  float* part_s = h_s + 2 * NB * p.hpitch;                     // [kslices][NB][C]
  float* x_s = part_s + p.kslices * NB * C;                    // [2][NB][C] (f32 form)
  const T* w_d = w_hh + (size_t)d * H * H4;

  // column c = g U + u of this block is gate g of hidden unit rank U + u:
  // column g H + rank U + u of w_hh[d]
  for (int idx = tid; idx < p.kres * C; idx += blockDim.x) {
    const int k = idx / C, c = idx - k * C;
    const int g = c / U, j = rank * U + c - g * U;
    w_s[c * p.kpitch + k] = (k < H && j < H) ? w_d[(size_t)k * H4 + g * H + j] : narrow<T>(0.f);
  }
  for (int idx = tid; idx < 2 * NB * p.hpitch; idx += blockDim.x) h_s[idx] = 0.f;

  // the matvec role: column mc, k slice ms, rows [k0, k1): [k0, kr) from
  // shared memory, [max(k0, kres), min(k1, H)) from L2
  const int mc = tid % C, ms = tid / C;
  const bool mat = ms < p.kslices;
  const int k0 = ms * p.kchunk;
  const int k1 = min(k0 + p.kchunk, p.ktot);
  const int kr = min(k1, p.kres);
  const int mg = mc / U, mj = rank * U + mc - mg * U;
  // the cell role: hidden unit cj, row cb of the group
  const bool cell = tid < U * NB;
  const int cu = tid % U, cb = tid / U;
  const int cj = rank * U + cu;
  const bool live = cell && cj < H && b0 + cb < batch;
  float c_state = 0.f;
  float x_next[4] = {0.f, 0.f, 0.f, 0.f};  // the bf16 form's prefetch of xs[t + 1]

  // xs[t] for this thread's (row, unit), four gates: into x_s[buf] (f32,
  // cp.async) or into x_next (bf16, loads to registers)
  auto prefetch = [&](int t, int buf) {
    const T* src = xs + (((size_t)t * 2 + d) * batch + b0 + cb) * H4 + cj;
    if constexpr (kF32) {
      float* dst = x_s + (buf * NB + cb) * C + cu;
      if (live) {
#pragma unroll
        for (int g = 0; g < 4; ++g) cp_async4(dst + g * U, src + g * H);
      } else if (cell) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dst[g * U] = 0.f;
      }
    } else if (live) {
#pragma unroll
      for (int g = 0; g < 4; ++g) x_next[g] = widen(src[g * H]);
    }
  };

  prefetch(0, 0);
  cp_async_commit();
  // every block's w slice and both h buffers are set before any block
  // stores into another's
  cluster.sync();

  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    float gate[4];
    if constexpr (!kF32) {  // xs[t], prefetched a step ago; then xs[t + 1]
#pragma unroll
      for (int g = 0; g < 4; ++g) gate[g] = x_next[g];
    }
    if (t + 1 < t_len) prefetch(t + 1, cur ^ 1);
    cp_async_commit();  // possibly empty: one group per step keeps the count
    const float* hc = h_s + cur * NB * p.hpitch;
    if (mat) {
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      const T* wc = w_s + mc * p.kpitch;
#pragma unroll 4
      for (int k = k0; k < kr; k += 4) {
        const float4 w4 = load_w4(wc + k);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 h4 = *reinterpret_cast<const float4*>(hc + b * p.hpitch + k);
          acc[b] = fmaf(h4.x, w4.x, acc[b]);
          acc[b] = fmaf(h4.y, w4.y, acc[b]);
          acc[b] = fmaf(h4.z, w4.z, acc[b]);
          acc[b] = fmaf(h4.w, w4.w, acc[b]);
        }
      }
      if (k1 > p.kres && mj < H) {
        const T* wg = w_d + mg * H + mj;
        const int kend = min(k1, H);
        for (int k = max(k0, p.kres); k < kend; ++k) {
          const float w = widen(wg[(size_t)k * H4]);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b] = fmaf(hc[b * p.hpitch + k], w, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) part_s[(ms * NB + b) * C + mc] = acc[b];
    }
    __syncthreads();
    if (cell) {
      if constexpr (kF32) {
        cp_async_wait_all_but_newest();  // xs[t] has landed in x_s[cur]
        const float* xg = x_s + (cur * NB + cb) * C + cu;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = xg[g * U];
      }
      // the four gates' sums are four independent chains: slice-major
      // order keeps their loads in flight together
      for (int k = 0; k < p.kslices; ++k) {
        const float* pk = part_s + (k * NB + cb) * C + cu;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] += pk[g * U];
      }
      const float ig = sigmoid(gate[0]);
      const float fg = sigmoid(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid(gate[3]);
      c_state = fg * c_state + ig * gg;
      // h in T: rounded to bf16 in the bf16 form, before ys and the exchange
      const T hv = narrow<T>(cj < H ? og * tanhf(c_state) : 0.f);
      const float h = widen(hv);
      if (live) ys[(((size_t)t * 2 + d) * batch + b0 + cb) * H + cj] = hv;
      const int off = ((cur ^ 1) * NB + cb) * p.hpitch + cj;
      for (int r = 0; r < p.cs; ++r) cluster.map_shared_rank(h_s, r)[off] = h;
    }
    cluster.sync();
    cur ^= 1;
  }
}

// K6's grid, cluster, threads and shared memory at the same shape; T steps
// of the DSMEM exchange of h and the cluster barrier, nothing else. h
// counts steps and is never negative: the store keeps the loop alive
// without writing anything.
template <int NB>
__global__ void __launch_bounds__(kMaxThreads, 1)
cluster_floor_kernel(float* __restrict__ out, int t_len, const Plan p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [2][NB][hpitch]
  const int U = p.units;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 2 * NB * p.hpitch; idx += blockDim.x) h_s[idx] = 0.f;
  const bool cell = tid < U * NB;
  const int cb = tid / U, cj = rank * U + tid % U;
  cluster.sync();
  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    if (cell) {
      const float h = h_s[(cur * NB + cb) * p.hpitch + (cj + 1) % (p.cs * U)] + 1.f;
      const int off = ((cur ^ 1) * NB + cb) * p.hpitch + cj;
      for (int r = 0; r < p.cs; ++r) cluster.map_shared_rank(h_s, r)[off] = h;
    }
    cluster.sync();
    cur ^= 1;
  }
  if (cell && h_s[(cur * NB + cb) * p.hpitch + cj] < 0.f) *out = 1.f;
}

// the first form's floor: one block per direction and pair of rows, H
// threads rounded to a warp, T steps of a shared-memory exchange and
// __syncthreads
__global__ void block_floor_kernel(float* __restrict__ out, int t_len) {
  extern __shared__ float hs[];  // [2][blockDim.x]
  const int j = threadIdx.x;
  const int n = blockDim.x;
  hs[j] = 0.f;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    hs[(cur ^ 1) * n + j] = hs[cur * n + (j + 1) % n] + 1.f;
    __syncthreads();
    cur ^= 1;
  }
  if (hs[cur * n + j] < 0.f) *out = hs[cur * n + j];
}

bool bad_shape(int t_len, int batch, int hidden) {
  return t_len < 1 || batch < 1 || hidden < 1 || hidden > kMaxHidden ||
         (batch + kMaxRows - 1) / kMaxRows > 65535;
}

cudaLaunchConfig_t cluster_config(const Plan& p, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, 2, p.groups);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Cluster launches of `kernel` allowed at 16 blocks and up to all of an
// SM's shared memory (a launch passes its own size); idempotent.
template <typename Kernel>
cudaError_t allow_cluster_launch(Kernel kernel) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

// K6's plan at this shape for elements T, at the largest cluster size that
// the card can place (16, else 8): found with
// cudaOccupancyMaxActiveClusters on the first call at a hidden size,
// before any launch at it, and kept.
template <typename T, int NB>
cudaError_t plan_for(int hidden, int batch, cudaStream_t s, Plan* out) {
  static std::mutex mu;
  static int cluster_size[kMaxHidden + 1];  // 0: not yet chosen
  constexpr int esize = (int)sizeof(T);
  std::lock_guard<std::mutex> lock(mu);
  if (cluster_size[hidden]) {
    *out = make_plan(hidden, batch, cluster_size[hidden], esize);
    return cudaSuccess;
  }
  cudaError_t err = allow_cluster_launch(bilstm_cluster_kernel<T, NB>);
  if (err != cudaSuccess) return err;
  for (int cs : kClusterSizes) {
    const Plan p = make_plan(hidden, batch, cs, esize);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(p, s, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)bilstm_cluster_kernel<T, NB>,
                                         &cfg);
    if (err == cudaSuccess && clusters > 0) {
      cluster_size[hidden] = cs;
      *out = p;
      return cudaSuccess;
    }
    cudaGetLastError();  // a size the card refuses is not this call's error
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

template <typename T, int NB>
cudaError_t launch_rows(const T* xs, const T* w_hh, T* ys, int t_len, int batch, int hidden,
                        cudaStream_t s) {
  Plan p;
  cudaError_t err = plan_for<T, NB>(hidden, batch, s, &p);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, s, &attr);
  err = cudaLaunchKernelEx(&cfg, bilstm_cluster_kernel<T, NB>, xs, w_hh, ys, t_len, batch,
                           hidden, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_recurrence(const void* xs, const void* w_hh, void* ys, int t_len, int batch,
                              int hidden, void* stream) {
  if (bad_shape(t_len, batch, hidden)) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xs);
  const T* w = static_cast<const T*>(w_hh);
  T* y = static_cast<T*>(ys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_for(batch)) {
    case 1: return launch_rows<T, 1>(x, w, y, t_len, batch, hidden, s);
    case 2: return launch_rows<T, 2>(x, w, y, t_len, batch, hidden, s);
    case 4: return launch_rows<T, 4>(x, w, y, t_len, batch, hidden, s);
    default: return launch_rows<T, 8>(x, w, y, t_len, batch, hidden, s);
  }
}

template <int NB>
cudaError_t launch_floor_rows(float* out, int t_len, int batch, int hidden, cudaStream_t s) {
  // K6's f32 plan at this shape (its cluster size and shared memory), so
  // the floor runs with the same residency
  Plan p;
  cudaError_t err = plan_for<float, NB>(hidden, batch, s, &p);
  if (err != cudaSuccess) return err;
  err = allow_cluster_launch(cluster_floor_kernel<NB>);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, s, &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_floor_kernel<NB>, out, t_len, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K6: xs (T, 2, B, 4H), w_hh (2, H, 4H), ys (T, 2, B, H), contiguous, all
// f32 or all bf16
extern "C" int bilstm_recurrence_f32(const void* xs, const void* w_hh, void* ys, int t_len,
                                     int batch, int hidden, void* stream) {
  return (int)launch_recurrence<float>(xs, w_hh, ys, t_len, batch, hidden, stream);
}

extern "C" int bilstm_recurrence_bf16(const void* xs, const void* w_hh, void* ys, int t_len,
                                      int batch, int hidden, void* stream) {
  return (int)launch_recurrence<__nv_bfloat16>(xs, w_hh, ys, t_len, batch, hidden, stream);
}

// K6's grid, cluster and shared memory at this shape running T steps of
// the DSMEM exchange and the cluster barrier; out is one float, never
// written
extern "C" int bilstm_cluster_floor(void* out, int t_len, int batch, int hidden,
                                    void* stream) {
  if (bad_shape(t_len, batch, hidden)) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_for(batch)) {
    case 1: return (int)launch_floor_rows<1>(o, t_len, batch, hidden, s);
    case 2: return (int)launch_floor_rows<2>(o, t_len, batch, hidden, s);
    case 4: return (int)launch_floor_rows<4>(o, t_len, batch, hidden, s);
    default: return (int)launch_floor_rows<8>(o, t_len, batch, hidden, s);
  }
}

// the first form's grid (2, ceil(B / 2)) and H threads rounded to a warp,
// T steps of __syncthreads; out is one float, never written
extern "C" int bilstm_block_floor(void* out, int t_len, int batch, int hidden,
                                  void* stream) {
  if (bad_shape(t_len, batch, hidden) || (batch + 1) / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const int n = (hidden + 31) / 32 * 32;
  const dim3 grid(2, (batch + 1) / 2);
  block_floor_kernel<<<grid, n, sizeof(float) * 2 * n, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), t_len);
  return (int)cudaGetLastError();
}

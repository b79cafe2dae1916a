// BiLSTM recurrence (K6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel demucs_tpu/ops/pallas/lstm.py:
// bilstm_recurrence (_bilstm_kernel): both directions of one BiLSTM
// layer's recurrence in one launch. From
//   xs   (T, 2, B, 4H) f32: the input projections plus both biases,
//        direction 1 already time-flipped,
//   w_hh (2, H, 4H)    f32: the recurrent weights, transposed,
// it writes ys (T, 2, B, H) f32 (direction 1 still flipped). h and c start
// at zero; per step and direction
//   gates = xs[t, d] + h @ w_hh[d]            (gate order i, f, g, o)
//   c = sigmoid(f) c + sigmoid(i) tanh(g),    h = sigmoid(o) tanh(c)
// in f32 with expf and tanhf (no fast-math intrinsics).
//
// What bounds it: the work is small (16 T B H^2 flops, 0.4-0.8 GFLOP at
// the Demucs shapes, ~10 us at the f32 peak) and so are the bytes (xs,
// w_hh and ys once, 6-10 MB, ~3 us at HBM speed). What no form avoids is
// the chain of T dependent steps: each needs all of h from the step
// before, so each ends in a barrier. The TPU kernel keeps both w_hh
// resident in VMEM for the whole scan; on the H100 one direction's w_hh
// (590 KB at H=192, 2.36 MB at H=384) does not fit an SM's 227 KB of
// shared memory, so here every step streams it from the 50 MB L2.
//
// Design (the simple form):
//   * one persistent block per direction and pair of batch rows (grid
//     (2, ceil(B / 2))), H threads rounded up to a whole warp. Measured on
//     the H100: one row per block ran 2.4x slower than two (the compiler
//     kept fewer w_hh loads in flight). More rows per block would lengthen
//     each block's pass over w_hh while other SMs idle: B rows take
//     ceil(B / 2) blocks per direction, whose passes run side by side;
//   * thread j owns hidden unit j: its gate columns j, H+j, 2H+j, 3H+j,
//     so a warp's reads of one w_hh row coalesce, and its cell state c for
//     the block's rows lives in registers;
//   * h of the block's rows sits in shared memory, double-buffered: step t
//     reads one buffer and writes the other, so one __syncthreads() per
//     step orders step t's writes before step t+1's reads;
//   * a row past B (odd B) computes on zeros and is not stored.
// A step thus costs one pass of one SM over w_hh from L2. The fast form,
// a cluster of blocks each holding a slice of w_hh in shared memory with h
// exchanged through distributed shared memory, is later work.
//
// barrier_floor_kernel is not part of the model: it runs the same grid
// and T steps of nothing but an exchange of h through shared memory and
// the barrier, the sequential floor that no form of K6 beats.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHidden = 512;  // threads per block; the v3 shapes use 192 and 384
constexpr int NB = 2;            // batch rows per block

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kMaxHidden)
bilstm_kernel(const float* __restrict__ xs, const float* __restrict__ w_hh,
              float* __restrict__ ys, int t_len, int batch, int hidden) {
  extern __shared__ float hs[];  // [2][NB][hidden]
  const int d = blockIdx.x;
  const int b0 = blockIdx.y * NB;
  const int j = threadIdx.x;
  const int H = hidden;
  const size_t H4 = 4 * (size_t)hidden;
  const float* w = w_hh + (size_t)d * H * H4 + j;

  for (int idx = threadIdx.x; idx < NB * H; idx += blockDim.x) hs[idx] = 0.f;
  float c[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) c[b] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    const float* hcur = hs + cur * NB * H;
    float* hnxt = hs + (cur ^ 1) * NB * H;
    if (j < H) {
      float acc[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const bool valid = b0 + b < batch;
        const float* x = xs + (((size_t)t * 2 + d) * batch + b0 + b) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[b][g] = valid ? x[g * H] : 0.f;
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float* wr = w + (size_t)k * H4;
        const float w0 = wr[0], w1 = wr[H], w2 = wr[2 * H], w3 = wr[3 * H];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float hk = hcur[b * H + k];
          acc[b][0] = fmaf(hk, w0, acc[b][0]);
          acc[b][1] = fmaf(hk, w1, acc[b][1]);
          acc[b][2] = fmaf(hk, w2, acc[b][2]);
          acc[b][3] = fmaf(hk, w3, acc[b][3]);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float i = sigmoid(acc[b][0]);
        const float f = sigmoid(acc[b][1]);
        const float g = tanhf(acc[b][2]);
        const float o = sigmoid(acc[b][3]);
        c[b] = f * c[b] + i * g;
        const float h = o * tanhf(c[b]);
        hnxt[b * H + j] = h;
        if (b0 + b < batch) ys[(((size_t)t * 2 + d) * batch + b0 + b) * H + j] = h;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

__global__ void barrier_floor_kernel(float* __restrict__ out, int t_len) {
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
  // h counts steps and is never negative: the store keeps the loop alive
  // without writing anything
  if (hs[cur * n + j] < 0.f) *out = hs[cur * n + j];
}

int threads_for(int hidden) { return (hidden + 31) / 32 * 32; }

bool bad_shape(int t_len, int batch, int hidden) {
  return t_len < 1 || batch < 1 || hidden < 1 || hidden > kMaxHidden ||
         (batch + NB - 1) / NB > 65535;
}

}  // namespace

extern "C" int bilstm_recurrence_f32(const void* xs, const void* w_hh, void* ys, int t_len,
                                     int batch, int hidden, void* stream) {
  if (bad_shape(t_len, batch, hidden)) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * 2 * NB * (size_t)hidden;
  const dim3 grid(2, (batch + NB - 1) / NB);
  bilstm_kernel<<<grid, threads_for(hidden), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w_hh), static_cast<float*>(ys),
      t_len, batch, hidden);
  return (int)cudaGetLastError();
}

// the grid and block of bilstm_recurrence_f32 at the same shape; out is one
// float, which is never written
extern "C" int bilstm_barrier_floor(void* out, int t_len, int batch, int hidden,
                                    void* stream) {
  if (bad_shape(t_len, batch, hidden)) return (int)cudaErrorInvalidValue;
  const int n = threads_for(hidden);
  const dim3 grid(2, (batch + NB - 1) / NB);
  barrier_floor_kernel<<<grid, n, sizeof(float) * 2 * n, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), t_len);
  return (int)cudaGetLastError();
}

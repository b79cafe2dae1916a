// int8-dequant matmul (K7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel demucs_tpu/ops/pallas/quant_matmul.py:
// int8_matmul (_kernel): a product in nn.Linear layout against a weight
// held as int8 with one f32 scale per output channel. From
//   x     (M, K) f32    the activations, M = B x tokens,
//   q     (N, K) int8   the quantized weight,
//   scale (N,)   f32    its per-output-channel scale,
//   bias  (N,)   f32    or null,
// it writes y (M, N) f32 with
//   y[m, n] = (sum_k x[m, k] * float(q[n, k])) * scale[n] + bias[n],
// as the TPU kernel does: the weight is widened inside the kernel (int8 ->
// f32 is exact), the sum is taken in f32 over k in order, and the scale is
// applied once, after the sum. The TPU kernel feeds its matrix unit bf16;
// the port's int8 path runs f32 activations, as the JAX package's --int8
// path does at f32, so x stays f32 here.
//
// What bounds it on an H100: at the Demucs shapes (K, N in {512, 2048},
// M = B x {2688, 1344}) the product does 2MNK flops on a few MB of
// operands, so it is bound by operations on the CUDA cores (f32, no
// tensor cores: 67 TFLOP/s), not by the bytes; the int8 weight is a
// quarter of the f32 one, which matters only at small M.
//
// Design (the simple form): a classic register-blocked SGEMM.
//   * one block of 256 threads per 128 x 64 tile of y (grid (ceil(N/64),
//     ceil(M/128))); each thread owns an 8 x 4 block of y in registers;
//   * the K axis goes in tiles of 16: each thread loads its part of the
//     next x tile (f32) and q tile (int8, 4 bytes at a time, widened to
//     f32) into registers while the current tiles are multiplied, then
//     stores them transposed into the other of two shared-memory buffers,
//     so one __syncthreads() per tile orders the writes before the reads;
//   * per k a thread reads 8 x values and 4 widened weights as three
//     16-byte shared loads and does 32 FMAs;
//   * ragged M, N and K are masked: out-of-range operands load as zero and
//     out-of-range outputs are not stored. Where K % 4 == 0 and the
//     pointers are aligned (the `vec` path) x and q are read 16 and 4
//     bytes at a time, else one element at a time;
//   * the epilogue multiplies by scale[n] and adds bias[n].
// The fast forms (wgmma on TF32 or split-bf16 operands, a bf16-x form for
// the bf16 path) are later work.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): the entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows of y per block
constexpr int BN = 64;   // columns of y per block
constexpr int BK = 16;   // depth of a K tile
constexpr int TM = 8;    // rows of y per thread
constexpr int TN = 4;    // columns of y per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;   // keeps rows 16-byte aligned, spreads the transposed stores
constexpr int kXPer = BM * BK / kThreads;         // 8 x values staged per thread
constexpr int kQPer = BN * BK / kThreads;         // 4 weights staged per thread

struct Tiles {
  float x[2][BK][BM + PAD];  // x tile, transposed: [k][m]
  float w[2][BK][BN + PAD];  // widened q tile, transposed: [k][n]
};

// Global -> registers for the K tile at k0. kVec: x as float4 (two per
// thread: rows f / 4, columns 4 (f % 4)), q as char4 (one per thread: row
// tid / 4, columns 4 (tid % 4)); otherwise one element at a time (x rows
// e / 16, column e % 16).
template <bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          const int8_t* __restrict__ q, int M, int N,
                                          int K, int m0, int n0, int k0, int tid,
                                          float (&xr)[kXPer], float (&wr)[kQPer]) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kXPer / 4; ++i) {
      const int f = tid + i * kThreads;
      const int m = m0 + f / (BK / 4), k = k0 + 4 * (f % (BK / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k < K) v = *reinterpret_cast<const float4*>(x + (size_t)m * K + k);
      xr[4 * i] = v.x;
      xr[4 * i + 1] = v.y;
      xr[4 * i + 2] = v.z;
      xr[4 * i + 3] = v.w;
    }
    const int n = n0 + tid / (BK / 4), k = k0 + 4 * (tid % (BK / 4));
    char4 c = make_char4(0, 0, 0, 0);
    if (n < N && k < K) c = *reinterpret_cast<const char4*>(q + (size_t)n * K + k);
    wr[0] = (float)c.x;
    wr[1] = (float)c.y;
    wr[2] = (float)c.z;
    wr[3] = (float)c.w;
  } else {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      const int m = m0 + e / BK, k = k0 + e % BK;
      xr[i] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kQPer; ++i) {
      const int e = tid + i * kThreads;
      const int n = n0 + e / BK, k = k0 + e % BK;
      wr[i] = (n < N && k < K) ? (float)q[(size_t)n * K + k] : 0.f;
    }
  }
}

// registers -> shared buffer `buf`, transposed; the same mapping as load_tile
template <bool kVec>
__device__ __forceinline__ void store_tile(Tiles& s, int buf, int tid,
                                           const float (&xr)[kXPer],
                                           const float (&wr)[kQPer]) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kXPer / 4; ++i) {
      const int f = tid + i * kThreads;
      const int m = f / (BK / 4), k = 4 * (f % (BK / 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) s.x[buf][k + j][m] = xr[4 * i + j];
    }
    const int n = tid / (BK / 4), k = 4 * (tid % (BK / 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) s.w[buf][k + j][n] = wr[j];
  } else {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      s.x[buf][e % BK][e / BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kQPer; ++i) {
      const int e = tid + i * kThreads;
      s.w[buf][e % BK][e / BK] = wr[i];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) Tiles s;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / (BN / TN);  // rows ty*8 .. ty*8+7 of the tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float xr[kXPer], wr[kQPer];
  const int tiles = (K + BK - 1) / BK;
  load_tile<kVec>(x, q, M, N, K, m0, n0, 0, tid, xr, wr);
  store_tile<kVec>(s, 0, tid, xr, wr);
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < tiles;
    if (more) load_tile<kVec>(x, q, M, N, K, m0, n0, (t + 1) * BK, tid, xr, wr);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.x[cur][kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.x[cur][kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.w[cur][kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (more) store_tile<kVec>(s, cur ^ 1, tid, xr, wr);
    __syncthreads();
  }

  const int n = n0 + tx * TN;
  float sc[TN], bi[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    sc[j] = n + j < N ? scale[n + j] : 0.f;
    bi[j] = (bias != nullptr && n + j < N) ? bias[n + j] : 0.f;
  }
  const bool whole = (N % 4 == 0) && n + TN <= N;  // a 16-byte aligned store
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) break;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = acc[i][j] * sc[j] + bi[j];
    float* row = y + (size_t)m * N;
    if (whole) {
      *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < N) row[n + j] = v[j];
    }
  }
}

}  // namespace

// y = (x @ float(q)^T) * scale (+ bias): x (M, K) f32, q (N, K) int8, scale
// and bias (N,) f32 (bias may be null), y (M, N) f32, all contiguous. vec != 0
// asks for 16-byte x and 4-byte q reads: K % 4 == 0, x 16-byte and q 4-byte
// aligned.
extern "C" int int8_matmul_f32(const void* x, const void* q, const void* scale,
                               const void* bias, void* y, int M, int N, int K, int vec,
                               void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535 || (vec && K % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (vec)
    int8_matmul_kernel<true><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N, K);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N, K);
  return (int)cudaGetLastError();
}

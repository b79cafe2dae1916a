// Fused flash-attention backward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel demucs_tpu/ops/pallas/attention.py:
// flash_mha_bwd (_mha_bwd_fused_kernel). Same maths, from the forward's
// per-row logsumexp (lse, natural log of the scaled logits, written by K2
// in flash_mha.cu) and delta = rowsum(dO * O), which the wrapper computes
// with one torch reduction before the launch (the JAX package computes it
// outside its kernel too):
//   P  = exp(scale * Q K^T - lse)     dP = dO V^T     dS = P * (dP - delta)
//   dQ = scale * dS K                 dK = scale * dS^T Q     dV = P^T dO
// The (T, S) matrices P, dP and dS never reach device memory.
//
// What bounds it: five products of 2*T*S*D flops each against q, k, v, o,
// dO, dq, dk, dv moved once, hundreds of flops per byte at the Demucs
// lengths, so it is bound by arithmetic (10*B*H*T*S*D flops).
//
// Design. The TPU kernel walks T tiles on a sequential grid axis and keeps
// full-S dK/dV blocks resident across it; Hopper's blocks run in parallel
// in no order, so the work is cut the other way:
//   * one block of 256 threads (16 x 16) owns one (batch*head, 64-key
//     S-tile); its K and V tiles sit in shared memory (f32, row stride
//     D + 4) and its dK and dV accumulators in registers, in f32;
//   * it loops over all T tiles of 64 query rows, loading Q, dO, lse and
//     delta for each; per tile each thread computes a 4 x 4 block of S^T
//     and dP^T (keys 4*ty + i, rows 16*j + tx) with the register blocking
//     of K1 (16 FMAs per two 128-bit shared reads), rebuilds P with exp2f
//     (lse is taken into the log2 domain on load), and writes P^T and
//     dS^T to shared memory;
//   * each thread then accumulates a 4-key x D/16-column block of
//     P^T dO and dS^T Q into dV and dK, and a 4-row x D/16-column block of
//     dS K, the tile's contribution to dQ;
//   * dQ sums over the S tiles that different blocks own. It is made
//     bit-reproducible by per-S-tile partials summed in a fixed order:
//     each block stores its tile's scale * dS K, with plain stores, in
//     slice blockIdx.x of an f32 workspace dq_part (n_s_tiles, BH, T, D),
//     and a second kernel, dq_reduce_kernel, sums the slices for each
//     element in s order and writes dq in the operand dtype. Why not the
//     other deterministic forms: an ordered turnstile (block s adds after
//     block s-1, a counter per (bh, T tile)) needs no workspace but holds
//     each block behind the one before it at every T tile and is safe only
//     while the blocks of one bh become resident in s order, which CUDA
//     does not promise; a second kernel over T tiles would recompute two of
//     the five products (QK^T and dO V^T), +40% of the arithmetic. The
//     partials cost bytes instead: n_s_tiles x BH x T x D x 4 written and
//     read once (0.92 GB at (4,8,2688,64), ~0.55 ms at 3.35 TB/s beside
//     the kernel's ~5 ms), and the workspace is transient;
//   * the ragged edges mask themselves: rows >= T load as zeros with an
//     lse of +inf (so P = 0), keys >= S load as zeros with P forced to 0,
//     and neither is stored;
//   * all arithmetic is f32 FMAs on the CUDA cores; bf16 operands are
//     widened on load and dK, dV are stored in the operand dtype.
//     wgmma and TMA are later work.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches both kernels on the given stream and
// returns cudaGetLastError(). dq_part needs no zeroing: every element of
// it that the reduction reads is stored first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per T tile
constexpr int kKeys = 64;      // keys per block
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kRows + 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// rows [0, n_valid) of a (rows, D) row-major tile of src into dst with row
// stride ld floats; rows past n_valid are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows, int n_valid) {
  constexpr int D4 = D / 4;
  for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
    const int r = idx / D4;
    const int c = idx - r * D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = load4(src + (size_t)r * D + 4 * c);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // ks, vs (kKeys, D+4); qs, dos (kRows, D+4); pt, dst (kKeys, kRows+4);
  // lse2, dlt (kRows)
  return sizeof(float) * (2 * (size_t)kKeys * (D + 4) + 2 * (size_t)kRows * (D + 4) +
                          2 * (size_t)kKeys * kLdP + 2 * (size_t)kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq_part, T* __restrict__ dk, T* __restrict__ dv,
               int t_len, int s_len, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;  // columns per thread in the D-wide products
  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kKeys * kLd;
  float* qs = vs + kKeys * kLd;
  float* dos = qs + kRows * kLd;
  float* pt = dos + kRows * kLd;   // P^T (keys, rows)
  float* dst = pt + kKeys * kLdP;  // dS^T (keys, rows)
  float* lse2 = dst + kKeys * kLdP;
  float* dlt = lse2 + kRows;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kKeys;
  const int nk = min(kKeys, s_len - key0);
  const float scale_log2 = scale * kLog2e;

  load_tile<T, D>(ks, kLd, k + ((size_t)bh * s_len + key0) * D, kKeys, nk);
  load_tile<T, D>(vs, kLd, v + ((size_t)bh * s_len + key0) * D, kKeys, nk);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kRows) {
    const int nt = min(kRows, t_len - t0);
    const size_t row_base = (size_t)bh * t_len + t0;
    __syncthreads();  // the previous tile's qs, dos, pt, dst are no longer read
    load_tile<T, D>(qs, kLd, q + row_base * D, kRows, nt);
    load_tile<T, D>(dos, kLd, dout + row_base * D, kRows, nt);
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      lse2[r] = r < nt ? lse[row_base + r] * kLog2e : INFINITY;
      dlt[r] = r < nt ? delta[row_base + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys 4*ty + i, rows 16*j + tx
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(ks + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(qs + (16 * j + tx) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(vs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(dos + (16 * j + tx) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
    }

    // P and dS, stored transposed (keys, rows)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 16 * j + tx;
        const float p = key < nk ? exp2f(fmaf(s[i][j], scale_log2, -lse2[row])) : 0.f;
        pt[key * kLdP + row] = p;
        dst[key * kLdP + row] = p * (dp[i][j] - dlt[row]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys 4*ty + i, columns kCols*tx + c
#pragma unroll 2
    for (int r = 0; r < kRows; r += 4) {
      float4 p4[4], s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(pt + (4 * ty + i) * kLdP + r);
        s4[i] = *reinterpret_cast<const float4*>(dst + (4 * ty + i) * kLdP + r);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float dov[kCols], qv[kCols];
        const float* dorow = dos + (r + rr) * kLd + kCols * tx;
        const float* qrow = qs + (r + rr) * kLd + kCols * tx;
        if constexpr (kCols == 4) {
          const float4 x = *reinterpret_cast<const float4*>(dorow);
          const float4 y = *reinterpret_cast<const float4*>(qrow);
          dov[0] = x.x; dov[1] = x.y; dov[2] = x.z; dov[3] = x.w;
          qv[0] = y.x; qv[1] = y.y; qv[2] = y.z; qv[3] = y.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dov[c] = dorow[c];
            qv[c] = qrow[c];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = lane(p4[i], rr);
          const float sij = lane(s4[i], rr);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[i][c] = fmaf(pij, dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(sij, qv[c], dk_acc[i][c]);
          }
        }
      }
    }

    // this tile's dQ = scale * dS K: rows 4*ty + i, columns kCols*tx + c
    float dq[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + key * kLdP + 4 * ty);
      float kv[kCols];
      const float* krow = ks + key * kLd + kCols * tx;
      if constexpr (kCols == 4) {
        const float4 x = *reinterpret_cast<const float4*>(krow);
        kv[0] = x.x; kv[1] = x.y; kv[2] = x.z; kv[3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = krow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsi = lane(d4, i);
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[i][c] = fmaf(dsi, kv[c], dq[i][c]);
      }
    }
    // this S tile's slice of the workspace: plain stores, no atomics
    float* part = dq_part + ((size_t)blockIdx.x * gridDim.y * t_len + row_base) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * ty + i;
      if (row < nt) {
        float* out = part + (size_t)row * D + kCols * tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) out[c] = dq[i][c] * scale;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = 4 * ty + i;
    if (key < nk) {
      const size_t off = ((size_t)bh * s_len + key0 + key) * D + kCols * tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store1(dk + off + c, dk_acc[i][c] * scale);
        store1(dv + off + c, dv_acc[i][c]);
      }
    }
  }
}

// dq[e] = sum over s of dq_part[s][e], s = 0, 1, ..., n_parts - 1 in that
// order for every element e of (BH, T, D): the fixed order that makes dQ
// bit-reproducible. Four elements per thread, read as float4 (n % 4 == 0
// since D is).
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                                 size_t n, int n_parts) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 acc = load4(dq_part + i);
  for (int s = 1; s < n_parts; ++s) {
    const float4 x = load4(dq_part + (size_t)s * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store1(dq + i, acc.x);
  store1(dq + i + 1, acc.y);
  store1(dq + i + 2, acc.z);
  store1(dq + i + 3, acc.w);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                     const float* delta, float* dq_part, T* dq, T* dk, T* dv, int bh,
                     int t_len, int s_len, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kKeys - 1) / kKeys, bh);
  mha_bwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(q, k, v, dout, lse, delta, dq_part, dk,
                                                      dv, t_len, s_len, scale);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  const size_t n = (size_t)bh * t_len * D;
  constexpr int kReduceThreads = 256;
  const size_t blocks = (n / 4 + kReduceThreads - 1) / kReduceThreads;
  dq_reduce_kernel<T><<<(unsigned)blocks, kReduceThreads, 0, s>>>(dq_part, dq, n, grid.x);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq_part, void* dq, void* dk, void* dv, int bh, int t_len,
           int s_len, int d, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  float* dqpart = static_cast<float*>(dq_part);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  switch (d) {
    case 48:
      return (int)launch_d<T, 48>(qp, kp, vp, dop, lp, dlp, dqpart, dqp, dkp, dvp, bh, t_len, s_len,
                                  scale, s);
    case 64:
      return (int)launch_d<T, 64>(qp, kp, vp, dop, lp, dlp, dqpart, dqp, dkp, dvp, bh, t_len, s_len,
                                  scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout (BH, T, D) and k, v (BH, S, D) in the operand dtype; lse, delta
// (BH, T) f32; dq_part (ceil(S / 64), BH, T, D) f32 workspace; dq (BH, T,
// D), dk, dv (BH, S, D) out in the operand dtype.
extern "C" int flash_mha_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq_part, void* dq, void* dk, void* dv, int bh,
                                 int t_len, int s_len, int d, void* stream) {
  return launch<float>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, t_len, s_len, d,
                       stream);
}

extern "C" int flash_mha_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq_part, void* dq, void* dk, void* dv, int bh,
                                  int t_len, int s_len, int d, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq_part, dq, dk, dv, bh, t_len,
                               s_len, d, stream);
}

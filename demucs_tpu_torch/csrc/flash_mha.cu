// Flash (online-softmax) multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel demucs_tpu/ops/pallas/attention.py:flash_mha
// (_mha_kernel). Same maths: non-causal attention of q (BH, T, D) over
// k, v (BH, S, D), softmax at 1/sqrt(D), with an f32 running max, running
// sum and accumulator, so the (T, S) logits never reach device memory.
//
// What bounds it: at the Demucs shapes (T, S in {1344, 2688}, D = 64) the
// work is 4*T*S*D flops against 4*T*D + 4*S*D elements moved, hundreds of
// flops per byte, so it is bound by arithmetic. This form runs that
// arithmetic as f32 FMAs on the CUDA cores (the f32 peak); for bf16
// operands it leaves the tensor cores idle (wgmma and TMA are later work).
//
// Design: the two products are register-blocked as in an f32 GEMM, so
// that shared memory feeds the FMA pipes instead of limiting them.
//   * one block of 256 threads (16 x 16) owns one (batch*head, 64-row
//     T-tile); the Q tile sits in shared memory, pre-scaled by
//     log2(e)/sqrt(D), widened to f32 (bf16 operands are computed in f32);
//   * the block streams K and V in tiles of 64 keys through shared memory;
//     per tile each thread computes a 4 x 4 block of logits (rows
//     4*ty + i, keys 16*j + tx) from float4 reads, 16 FMAs for every two
//     128-bit loads, with conflict-free row strides of D + 4;
//   * the online softmax runs in the log2 domain (exp2f): row max and row
//     sum are reduced over the 16 threads sharing a row with warp shuffles,
//     the accumulator is rescaled, and P goes to shared memory;
//   * each thread then accumulates a 4-row x D/16-column block of P.V;
//     the running max, sum and accumulator stay in registers, in f32;
//   * the ragged edges mask themselves: rows >= T are computed on zeros
//     and not stored, keys >= S get a logit of -inf and zero V rows.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // K/V rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys / D/16 columns
constexpr int kLdP = kKeys + 4;

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

// rows [0, n_valid) of a (rows, D) row-major tile of src, times scale,
// into dst with row stride ld floats; rows past n_valid are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows, int n_valid, float scale) {
  constexpr int D4 = D / 4;
  for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
    const int r = idx / D4;
    const int c = idx - r * D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      x = load4(src + (size_t)r * D + 4 * c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // qs (kRows, D+4), ks (kKeys, D+4), vs (kKeys, D), ps (kRows, kKeys+4)
  return sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)kKeys * (D + 4) +
                          (size_t)kKeys * D + (size_t)kRows * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               int t_len, int s_len, float scale_log2) {
  constexpr int kLd = D + 4;   // row stride of qs and ks
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * kLd;
  float* vs = ks + kKeys * kLd;
  float* ps = vs + kKeys * D;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const T* kb = k + (size_t)bh * s_len * D;
  const T* vb = v + (size_t)bh * s_len * D;

  load_tile<T, D>(qs, kLd, q + ((size_t)bh * t_len + row0) * D, kRows,
                  min(kRows, t_len - row0), scale_log2);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;  // running max (log2 domain); finite so exp2f(m - m_new) is 0, not NaN
    l[i] = 0.f;     // running sum of exp2(logit - m)
  }

  for (int s0 = 0; s0 < s_len; s0 += kKeys) {
    const int nk = min(kKeys, s_len - s0);
    __syncthreads();  // the previous tile's ks, vs, ps are no longer read
    load_tile<T, D>(ks, kLd, kb + (size_t)s0 * D, kKeys, nk, 1.f);
    load_tile<T, D>(vs, D, vb + (size_t)s0 * D, kKeys, nk, 1.f);
    __syncthreads();

    // logits: rows 4*ty + i, keys 16*j + tx
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (16 * j + tx) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax; the 16 threads of a row are lanes tx = 0..15 of one
    // half-warp, so xor-shuffles below 16 stay within the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (16 * j + tx >= nk) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sum += p;
        ps[(4 * ty + i) * kLdP + 16 * j + tx] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // P.V: rows 4*ty + i, columns kCols*tx + c
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCols];
        const float* vrow = vs + (j + jj) * D + kCols * tx;
        if constexpr (kCols == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row < t_len) {
      const float inv = 1.f / l[i];
      T* orow = o + ((size_t)bh * t_len + row) * D + kCols * tx;
#pragma unroll
      for (int c = 0; c < kCols; ++c) store1(orow + c, acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* o, int bh,
                     int t_len, int s_len, float scale_log2, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, bh);
  mha_fwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(q, k, v, o, t_len, s_len, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int t_len, int s_len, int d, void* stream) {
  if (bh < 1 || bh > 65535 || t_len < 1 || s_len < 1) return (int)cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (d) {
    case 48:
      return (int)launch_d<T, 48>(qp, kp, vp, op, bh, t_len, s_len, scale_log2, s);
    case 64:
      return (int)launch_d<T, 64>(qp, kp, vp, op, bh, t_len, s_len, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_mha_f32(const void* q, const void* k, const void* v, void* o,
                             int bh, int t_len, int s_len, int d, void* stream) {
  return launch<float>(q, k, v, o, bh, t_len, s_len, d, stream);
}

extern "C" int flash_mha_bf16(const void* q, const void* k, const void* v, void* o,
                              int bh, int t_len, int s_len, int d, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, t_len, s_len, d, stream);
}

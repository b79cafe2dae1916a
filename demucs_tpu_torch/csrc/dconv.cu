// The fused DConv kernels for Hopper (sm_90a): K5, one whole DConv
// sub-block, and K4, its GroupNorm -> GLU -> LayerScale -> residual tail.
//
// K5 (dconv_sub_block_f32) replaces the Pallas TPU kernel
// demucs_tpu/ops/pallas/dconv.py:dconv_sub_block (_sub_block_kernel). On
// every row n of x (N, C, T) f32 it computes
//   y   = conv1d(x, w0 (h, C, 3), b0, padding = dilation = d)   C -> h
//   y   = GELU(GroupNorm1(y; g1, be1))                          exact erf
//   z   = w3 (2C, h) y + b3                                     h -> 2C
//   z   = GroupNorm1(z; g4, be4)
//   out = x + scale * z[:C] * sigmoid(z[C:])
// K4 (gn_glu_scale_res_f32) replaces demucs_tpu/ops/pallas/norms.py:
// gn_glu_scale_res (_gn_glu_res_kernel): out = res + scale *
// GLU(GroupNorm1(x; weight, bias)) from x (R, 2C, T) and res (R, C, T).
// Both keep the port's statistics convention (ops/norms.py): one-pass
// mean and biased variance E[v^2] - mean^2 in f32, clamped at 0, eps 1e-5.
//
// What bounds them: K4 does ~10 operations per element, far below the
// f32 line of ~20 operations per byte, so bytes (x and res read once, out
// written once). K5 moves 8 bytes per element of x (x read, out written)
// and does 2 * (3 C h + 2 C h) / C = 10 h operations per element: below
// the line at the narrow levels (h = 6, 12), above it at the wide ones
// (h = 48, 96), so bytes there and operations here.
//
// The design problem: GroupNorm(1) takes its statistics over a row's whole
// (h, T), and then its whole (2C, T), and a row (64 KB to 16.5 MB of x on
// the Demucs paths) does not fit an SM's 227 KB of shared memory, where
// the TPU kernel held whole rows in VMEM. So the statistics cross blocks:
// every launch tiles T, and the row's sums go through device memory as
// per-(row, tile) partial sums that the next launch reduces in a fixed
// order (deterministic, no atomics). K5 is three launches:
//   (a) conv0 with the +-d halo (zero-padded at the row's ends, never read
//       across rows) -> y (N, h, T) in a workspace, partial sums of y, y^2;
//   (b) GroupNorm1 + GELU of the tile, written back over y, and z of the
//       tile in registers -> partial sums of z, z^2 only;
//   (c) z again, GroupNorm2, GLU, LayerScale and the residual -> out.
// So x is read twice, out written once, and the h-row workspace twice
// each way; z (2C rows) never reaches device memory. K4 is two launches:
// partial sums, then the apply.
//
// Layout: a K5 block walks one or more 32-column tiles of one row (lane =
// column, so every load and store of a (channel, tile) row is one
// coalesced 128-byte line; a row of more than 1024 tiles gives each block
// several, so that no launch reduces more than 1024 partials per row) with
// up to 8 warps, which split the output channels; each thread
// keeps 8 (conv0) or 16 (z) outputs in registers and streams the weights,
// which every lane reads at the same address (a broadcast). The weights in
// shared memory, several columns per thread and the tensor cores are later
// work; this is the simple form.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;         // K5 columns per block, one per lane
constexpr int kMaxWarps = 8;      // K5 warps per block
constexpr int kConvOut = 8;       // conv0 outputs per thread and pass
constexpr int kZOut = 16;         // z rows per thread and pass in (b)
constexpr int kPairs = 8;         // GLU pairs (16 z rows) per thread and pass in (c)
constexpr int kMaxParts = 1024;   // K5 partial sums per row at most
constexpr int kThreads = 256;     // K4 threads per block
constexpr int kPerThread = 8;     // K4 elements per thread
constexpr int kChunk = kThreads * kPerThread;
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// (a, b) summed over the block in a fixed order: lanes by xor shuffles,
// then warps in order. Every thread returns the block's sums. red holds
// 2 * (warps per block) floats; the block size is a multiple of 32.
__device__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warps = blockDim.x * blockDim.y / 32;
  __syncthreads();  // red may still be read from an earlier call
  if (tid % 32 == 0) {
    red[tid / 32] = a;
    red[warps + tid / 32] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  for (int w = 0; w < warps; ++w) {
    sa += red[w];
    sb += red[warps + w];
  }
  return make_float2(sa, sb);
}

// mean and 1/sqrt(var + eps) of one row from its n_parts partial (sum,
// sum of squares) pairs, over count elements; every thread gets them
__device__ float2 row_stats(const float* __restrict__ part, int n_parts, float count,
                            float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n = blockDim.x * blockDim.y;
  float a = 0.f, b = 0.f;
  for (int i = tid; i < n_parts; i += n) {
    a += part[2 * i];
    b += part[2 * i + 1];
  }
  const float2 s = block_sum2(a, b, red);
  const float mean = s.x / count;
  const float var = fmaxf(s.y / count - mean * mean, 0.f);
  return make_float2(mean, 1.f / sqrtf(var + kEps));
}

__device__ __forceinline__ float norm(float v, float2 st, float w, float b) {
  return (v - st.x) * st.y * w + b;
}

// ---- K5 -------------------------------------------------------------------

// The block's tiles: tile blockIdx.x * per_block + sub of the row, column
// t of this thread (at or past T on the ragged edge)
__device__ __forceinline__ int column(int per_block, int sub) {
  return (blockIdx.x * per_block + sub) * kTile + threadIdx.x;
}

// (a) on one tile: y = conv0(x) at column t, stored; its sums added to s, s2
__device__ __forceinline__ void conv0_tile(const float* __restrict__ xr,
                                           const float* __restrict__ w0,
                                           const float* __restrict__ b0, float* __restrict__ yr,
                                           int C, int h, int T, int dil, int t, float& s,
                                           float& s2) {
  const bool valid = t < T;
  const bool has_left = valid && t >= dil;
  const bool has_right = t + dil < T;
  for (int o0 = threadIdx.y * kConvOut; o0 < h; o0 += blockDim.y * kConvOut) {
    float acc[kConvOut];
#pragma unroll
    for (int r = 0; r < kConvOut; ++r) acc[r] = b0[min(o0 + r, h - 1)];
    for (int c = 0; c < C; ++c) {
      const float* xc = xr + (size_t)c * T;
      const float xl = has_left ? xc[t - dil] : 0.f;
      const float xm = valid ? xc[t] : 0.f;
      const float xh = has_right ? xc[t + dil] : 0.f;
#pragma unroll
      for (int r = 0; r < kConvOut; ++r) {
        const float* w = w0 + ((size_t)min(o0 + r, h - 1) * C + c) * 3;
        acc[r] = fmaf(w[0], xl, acc[r]);
        acc[r] = fmaf(w[1], xm, acc[r]);
        acc[r] = fmaf(w[2], xh, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kConvOut; ++r) {
      if (valid && o0 + r < h) {
        yr[(size_t)(o0 + r) * T + t] = acc[r];
        s += acc[r];
        s2 += acc[r] * acc[r];
      }
    }
  }
}

// (a): y = conv0(x) on the block's tiles, and their partial sums; grid
// (blocks per row, N), block (32, warps)
__global__ void __launch_bounds__(kTile * kMaxWarps)
dconv_conv0_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                   const float* __restrict__ b0, float* __restrict__ y,
                   float* __restrict__ part, int C, int h, int T, int dil, int per_block) {
  __shared__ float red[2 * kMaxWarps];
  const size_t n = blockIdx.y;
  float s = 0.f, s2 = 0.f;
  for (int sub = 0; sub < per_block; ++sub)
    conv0_tile(x + n * C * T, w0, b0, y + n * h * T, C, h, T, dil, column(per_block, sub), s,
               s2);
  const float2 tot = block_sum2(s, s2, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    float* p = part + (n * gridDim.x + blockIdx.x) * 2;
    p[0] = tot.x;
    p[1] = tot.y;
  }
}

// the tile of GELU(GroupNorm1(y)) at column t into shared memory, yg[j *
// kTile + lane] (zeros past T), and over y in device memory
__device__ void load_yg(float* yg, float* __restrict__ yr, const float* __restrict__ g1,
                        const float* __restrict__ be1, float2 st, int h, int T, int t) {
  __syncthreads();  // the block's reads of the previous tile are done
  for (int j = threadIdx.y; j < h; j += blockDim.y) {
    float v = 0.f;
    if (t < T) {
      float* p = yr + (size_t)j * T + t;
      v = gelu(norm(*p, st, g1[j], be1[j]));
      *p = v;
    }
    yg[j * kTile + threadIdx.x] = v;
  }
  __syncthreads();
}

// (b) on one tile: z = w3 yg + b3 at column t; its sums added to s, s2
__device__ __forceinline__ void z_tile(const float* yg, const float* __restrict__ w3,
                                       const float* __restrict__ b3, int C2, int h, bool valid,
                                       float& s, float& s2) {
  for (int o0 = threadIdx.y * kZOut; o0 < C2; o0 += blockDim.y * kZOut) {
    float acc[kZOut];
#pragma unroll
    for (int r = 0; r < kZOut; ++r) acc[r] = b3[min(o0 + r, C2 - 1)];
    for (int j = 0; j < h; ++j) {
      const float v = yg[j * kTile + threadIdx.x];
#pragma unroll
      for (int r = 0; r < kZOut; ++r)
        acc[r] = fmaf(w3[(size_t)min(o0 + r, C2 - 1) * h + j], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kZOut; ++r) {
      if (valid && o0 + r < C2) {
        s += acc[r];
        s2 += acc[r] * acc[r];
      }
    }
  }
}

// (b): GroupNorm1 + GELU over y in place, and the partial sums of z
__global__ void __launch_bounds__(kTile * kMaxWarps)
dconv_z_stats_kernel(float* __restrict__ y, const float* __restrict__ g1,
                     const float* __restrict__ be1, const float* __restrict__ w3,
                     const float* __restrict__ b3, const float* __restrict__ part1,
                     float* __restrict__ part2, int C, int h, int T, int per_block) {
  extern __shared__ float yg[];  // [h][kTile]
  __shared__ float red[2 * kMaxWarps];
  const size_t n = blockIdx.y;
  const int parts = gridDim.x;
  const float2 st = row_stats(part1 + n * parts * 2, parts, (float)h * T, red);
  float s = 0.f, s2 = 0.f;
  for (int sub = 0; sub < per_block; ++sub) {
    const int t = column(per_block, sub);
    load_yg(yg, y + n * h * T, g1, be1, st, h, T, t);
    z_tile(yg, w3, b3, 2 * C, h, t < T, s, s2);
  }
  const float2 tot = block_sum2(s, s2, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    float* p = part2 + (n * parts + blockIdx.x) * 2;
    p[0] = tot.x;
    p[1] = tot.y;
  }
}

// (c) on one tile: z again, GroupNorm2, GLU, LayerScale and the residual
// at column t
__device__ __forceinline__ void apply_tile(const float* __restrict__ xr, const float* yg,
                                           const float* __restrict__ w3,
                                           const float* __restrict__ b3,
                                           const float* __restrict__ g4,
                                           const float* __restrict__ be4,
                                           const float* __restrict__ scale, float2 st,
                                           float* __restrict__ outr, int C, int h, int T,
                                           int t) {
  for (int c0 = threadIdx.y * kPairs; c0 < C; c0 += blockDim.y * kPairs) {
    float a[kPairs], g[kPairs];
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int c = min(c0 + r, C - 1);
      a[r] = b3[c];
      g[r] = b3[C + c];
    }
    for (int j = 0; j < h; ++j) {
      const float v = yg[j * kTile + threadIdx.x];
#pragma unroll
      for (int r = 0; r < kPairs; ++r) {
        const size_t c = min(c0 + r, C - 1);
        a[r] = fmaf(w3[c * h + j], v, a[r]);
        g[r] = fmaf(w3[(C + c) * h + j], v, g[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int c = c0 + r;
      if (t < T && c < C) {
        const size_t i = (size_t)c * T + t;
        const float an = norm(a[r], st, g4[c], be4[c]);
        const float gn = norm(g[r], st, g4[C + c], be4[C + c]);
        outr[i] = xr[i] + an * sigmoid(gn) * scale[c];
      }
    }
  }
}

// (c): out = x + scale * GLU(GroupNorm2(z)) on the block's tiles
__global__ void __launch_bounds__(kTile * kMaxWarps)
dconv_apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   const float* __restrict__ g4, const float* __restrict__ be4,
                   const float* __restrict__ scale, const float* __restrict__ part2,
                   float* __restrict__ out, int C, int h, int T, int per_block) {
  extern __shared__ float yg[];  // [h][kTile]
  __shared__ float red[2 * kMaxWarps];
  const size_t n = blockIdx.y;
  const int parts = gridDim.x;
  const float2 st = row_stats(part2 + n * parts * 2, parts, 2.f * C * T, red);
  for (int sub = 0; sub < per_block; ++sub) {
    const int t = column(per_block, sub);
    __syncthreads();  // the block's reads of the previous tile are done
    for (int j = threadIdx.y; j < h; j += blockDim.y)
      yg[j * kTile + threadIdx.x] = t < T ? y[(n * h + j) * T + t] : 0.f;
    __syncthreads();
    apply_tile(x + n * C * T, yg, w3, b3, g4, be4, scale, st, out + n * C * T, C, h, T, t);
  }
}

// ---- K4 -------------------------------------------------------------------

// partial sums of one kChunk-element chunk of a row of x (R, 2C, T);
// grid (chunks, R), kThreads threads
__global__ void __launch_bounds__(kThreads)
gn_glu_stats_kernel(const float* __restrict__ x, float* __restrict__ part, int row_len) {
  __shared__ float red[2 * kThreads / 32];
  const float* xr = x + (size_t)blockIdx.y * row_len;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kChunk + k * kThreads + threadIdx.x;
    if (i < row_len) {
      const float v = xr[i];
      s += v;
      s2 += v * v;
    }
  }
  const float2 tot = block_sum2(s, s2, red);
  if (threadIdx.x == 0) {
    float* p = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
    p[0] = tot.x;
    p[1] = tot.y;
  }
}

// out = res + scale * GLU(GroupNorm1(x)) over one kChunk-element chunk of a
// row of out (R, C, T); grid (out chunks, R), kThreads threads
__global__ void __launch_bounds__(kThreads)
gn_glu_apply_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                    const float* __restrict__ bias, const float* __restrict__ scale,
                    const float* __restrict__ res, const float* __restrict__ part,
                    float* __restrict__ out, int n_parts, int C, int T) {
  __shared__ float red[2 * kThreads / 32];
  const int row_len = C * T;
  const size_t r = blockIdx.y;
  const float2 st = row_stats(part + r * n_parts * 2, n_parts, 2.f * row_len, red);
  const float* xr = x + r * 2 * row_len;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kChunk + k * kThreads + threadIdx.x;
    if (i < row_len) {
      const int c = i / T;
      const float an = norm(xr[i], st, weight[c], bias[c]);
      const float gn = norm(xr[row_len + i], st, weight[C + c], bias[C + c]);
      out[r * row_len + i] = res[r * row_len + i] + an * sigmoid(gn) * scale[c];
    }
  }
}

int warps_for(int outputs, int per_pass) {
  const int w = (outputs + per_pass - 1) / per_pass;
  return w < kMaxWarps ? w : kMaxWarps;
}

}  // namespace

// K5. x, out (N, C, T); w0 (h, C, 3); b0, g1, be1 (h); w3 (2C, h); b3, g4,
// be4 (2C); scale (C); workspaces y (N, h, T) and part1, part2 (N,
// ceil(T / 32), 2) (at most 1024 of them used), all f32 and contiguous. out
// must not alias x.
extern "C" int dconv_sub_block_f32(const void* x, const void* w0, const void* b0,
                                   const void* g1, const void* be1, const void* w3,
                                   const void* b3, const void* g4, const void* be4,
                                   const void* scale, void* y, void* part1, void* part2,
                                   void* out, int N, int C, int h, int T, int dil,
                                   void* stream) {
  if (N < 1 || N > 65535 || C < 1 || h < 1 || T < 1 || dil < 1)
    return (int)cudaErrorInvalidValue;
  const size_t yg_bytes = sizeof(float) * kTile * (size_t)h;
  if (yg_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* w3f = static_cast<const float*>(w3);
  const float* b3f = static_cast<const float*>(b3);
  float* yf = static_cast<float*>(y);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
  // a block takes several tiles of a long row, so that (b) and (c), whose
  // every block reduces the row's partial sums, read at most kMaxParts
  const int tiles = (T + kTile - 1) / kTile;
  const int per_block = (tiles + kMaxParts - 1) / kMaxParts;
  const dim3 grid((tiles + per_block - 1) / per_block, N);
  dconv_conv0_kernel<<<grid, dim3(kTile, warps_for(h, kConvOut)), 0, s>>>(
      xf, static_cast<const float*>(w0), static_cast<const float*>(b0), yf, p1, C, h, T, dil,
      per_block);
  dconv_z_stats_kernel<<<grid, dim3(kTile, warps_for(2 * C, kZOut)), yg_bytes, s>>>(
      yf, static_cast<const float*>(g1), static_cast<const float*>(be1), w3f, b3f, p1, p2, C,
      h, T, per_block);
  dconv_apply_kernel<<<grid, dim3(kTile, warps_for(C, kPairs)), yg_bytes, s>>>(
      xf, yf, w3f, b3f, static_cast<const float*>(g4), static_cast<const float*>(be4),
      static_cast<const float*>(scale), p2, static_cast<float*>(out), C, h, T, per_block);
  return (int)cudaGetLastError();
}

// K4. x (R, 2C, T); weight, bias (2C); scale (C); res, out (R, C, T);
// workspace part (R, ceil(2 C T / 2048), 2), all f32 and contiguous.
extern "C" int gn_glu_scale_res_f32(const void* x, const void* weight, const void* bias,
                                    const void* scale, const void* res, void* part, void* out,
                                    int R, int C, int T, void* stream) {
  if (R < 1 || R > 65535 || C < 1 || T < 1 || (long long)2 * C * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_len = 2 * C * T;
  const int n_parts = (row_len + kChunk - 1) / kChunk;
  const float* xf = static_cast<const float*>(x);
  float* p = static_cast<float*>(part);
  gn_glu_stats_kernel<<<dim3(n_parts, R), kThreads, 0, s>>>(xf, p, row_len);
  gn_glu_apply_kernel<<<dim3((C * T + kChunk - 1) / kChunk, R), kThreads, 0, s>>>(
      xf, static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<const float*>(res), p,
      static_cast<float*>(out), n_parts, C, T);
  return (int)cudaGetLastError();
}

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
// Each has an f32 and a bf16 form (the element type T of every tensor it
// reads and writes: x, the weights and vectors, res, out), as the TPU
// kernels read bf16 and compute in f32: in the bf16 form the loads widen
// to f32 on their way into shared memory (exactly: a bf16 value is the top
// half of an f32; through registers, 8 loads in flight a thread, as no
// cp.async copies 2 bytes), everything in between (shared rows, K5's y workspace,
// the partial sums, the statistics) is f32 as in the f32 form, and each
// output is rounded once (to nearest even) as it is stored. So the plans
// and the shared-memory sizes are the same in both forms, and the bf16
// form moves half the bytes of device memory.
//
// What bounds them: K4 does ~10 operations per element, far below the
// f32 line of ~20 operations per byte, so bytes (x and res read once, out
// written once). K5 moves 8 bytes per element of x (x read, out written)
// and does 2 * (3 C h + 2 C h) / C = 10 h operations per element: bytes
// bound it at h <= 12 (the first two levels of both families), the CUDA
// cores' f32 FMAs at h >= 24.
//
// K5. GroupNorm(1) takes its statistics over a row's whole (h, T), and
// then its whole (2C, T), before anything of the row can be written; the
// TPU kernel held whole rows in VMEM for that. The Demucs rows are of two
// kinds, and K5 has a form for each (the host picks it:
// ops/cuda/dconv.py:dconv_plan; check_plan below refuses a plan it cannot
// run):
//   * the frequency branch's rows are short (T = 336; 64.5-516 KB of x).
//     "row" and "cluster": one launch; a row, or a slice of it, stays in
//     shared memory from its load to its store, so device memory sees x
//     read once and out written once, the bound's own bytes (what bounds
//     the narrow levels). A block loads its x (and the weights, side by
//     side where both fit) with cp.async, computes y into shared memory,
//     reduces y's sums, applies GroupNorm1 and GELU in place, takes z's
//     sums, and computes z for GroupNorm2, GLU, LayerScale and the
//     residual, writing out once. "row" gives a block a whole row (C <=
//     96); "cluster" splits the row's T over a thread-block cluster of 2-8
//     blocks (C = 192, 384), each block reading its slice's +-d halo from
//     device memory. The two statistics are each block's sums combined
//     over distributed shared memory in rank order (one lane of one warp
//     per rank), one cluster barrier each: every block of the row
//     normalises with the same numbers. A block that fills an SM's shared
//     memory alone takes 512 threads, else 256. The cluster's size is the
//     host's choice by waves: a cluster must fit in one GPC, so the card
//     runs fewer clusters of 8 such blocks at once than 132 / 8.
//   * the time branch's rows are long (T = 1344-85995; 2.1-16.5 MB): no
//     row fits on chip. "tiles": three launches over tiles of 64-256
//     columns, the row statistics passed as per-(row, block) partial sums
//     in device memory that the next launch reduces in a fixed order (so
//     the forward is bit-reproducible, which training relies on; no
//     atomics): (a) conv0 -> y (N, h, T) in a workspace, and y's sums;
//     (b) GELU(GroupNorm1(y)) of the tile into shared memory and z's sums;
//     (c) the same, z and the output, x's rows copied in while the block
//     reduces the statistics. Where the tiles alone give less than one
//     wave of 132 SMs, blocks also split y's rows (a) and z's rows (b, c)
//     (time3: 2688 columns at B = 2). x is read twice and y (h/C of x)
//     once each way and twice back.
// All forms share one core, both convolutions as products from shared
// memory on the CUDA cores in f32 FMAs (what bounds the wide levels):
//   conv0  y[h, cols]  = W0[h, 3C] . X[3C, cols], X the three dilated
//          shifts of the x tile (zeros past the row's ends, never across
//          rows);
//   conv1  z[2C, cols] = W3[2C, h] . g[h, cols], g = GELU(GroupNorm1(y)).
// The weights are staged into shared memory once per block, in chunks of
// output rows where they do not fit (w0 is 221 KB at htdemucs' C = 384,
// 442 KB at hdemucs_mmi's), w3's rows interleaved (a_c, gate_c) so that a
// thread's z rows are whole GLU pairs. A warp takes 6 y rows (8 z rows)
// by 64 columns; each thread keeps 6 x 2 (8 x 2) outputs in registers,
// its two columns 32 apart so that every shared read of x or g is one
// conflict-free line, and the weights are float4 broadcasts. Per four
// input channels a thread reads 18 float4 of w0 and 24 values of x for
// 144 FMAs; per four hidden channels 8 float4 of w3 and 8 values of g for
// 64. Where a block has fewer warp tiles of y than warps, the warps of a
// tile split its input channels and add their sums in a fixed order.
// At h <= 24 z's sums come without z: sum_o z = w.g + sum b3 and sum_o
// z^2 = g^T G g + 2 u.g + sum b3^2 per column, from G = W3^T W3, u = W3^T
// b3 and w = W3^T 1 (2C h^2 operations per block against 2C h a column
// for z), so z is computed once, for the output. GroupNorm2's affine map,
// b3 and LayerScale fold into two coefficients per z row. The tensor
// cores (3xTF32) are later work.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the launch set-up).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;       // K5: threads per block of the tiles form
constexpr int kMaxBlock = 512;    // K5: threads per block at most (the row and cluster forms)
constexpr int kThreads = 256;     // K4: threads per block
constexpr int kTM0 = 6;           // K5: y rows per thread
constexpr int kTM3 = 8;           // K5: z rows per thread (4 GLU pairs)
constexpr int kTN = 2;            // K5: columns per thread, 32 apart
constexpr int kWarpCols = 32 * kTN;
constexpr int kRed = 48;          // K5: floats of reduction scratch (2 per warp) and cluster slots
constexpr int kSlots = 32;        // K5: the cluster slots' offset in it
constexpr int kMaxCluster = 8;    // K5: blocks per row at most (a portable cluster)
constexpr int kSmemLimit = 232448;  // 227 KB of shared memory per block
constexpr int kRowForm = 0, kTileForm = 1;
constexpr int kPerThread = 8;     // K4 elements per thread
constexpr int kChunk = kThreads * kPerThread;
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// K5's sigmoid: the exponential at (2 + 1.17 |v|) ulp (__expf) and the
// correctly rounded reciprocal; below 3e-6 relative for |v| < 20, where
// the gate's error moves the output by under 1e-6 of its scale
__device__ __forceinline__ float gate(float v) { return __frcp_rn(1.f + __expf(-v)); }

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

// mean and 1/sqrt(var + eps) from a row's (sum, sum of squares) over
// count elements
__device__ __forceinline__ float2 moments(float2 s, float count) {
  const float mean = s.x / count;
  const float var = fmaxf(s.y / count - mean * mean, 0.f);
  return make_float2(mean, 1.f / sqrtf(var + kEps));
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
  return moments(block_sum2(a, b, red), count);
}

__device__ __forceinline__ float norm(float v, float2 st, float w, float b) {
  return (v - st.x) * st.y * w + b;
}

// ---- K5 -------------------------------------------------------------------

// The shape of one call, with what the shared-memory layout derives
// from it.
struct Dims {
  int N, C, h, T, dil;
  int Cp, hp;   // C and h rounded up to 4 (zero rows beyond C and h)
  int P;        // halo columns staged on each side of a tile: dil rounded up to 4
  int K0;       // 3 Cp: floats per staged row of w0
  int vec;      // floats of the staged vectors (b0, g1, be1, b3, g4, be4, scale)
  int vx, vw0, vw3;  // x, w0, w3 can be staged 16 bytes at a time
};

// How one call cuts the work, from the host's dconv_plan.
struct Plan {
  int form;     // kRowForm (one launch) or kTileForm (three)
  int cols;     // columns per block: a slice of a row, or a tile
  int blocks;   // blocks per row: the cluster's size, or the tiles
  int splits0, rows0, chunk0;  // blocks sharing a tile's y rows, y rows per block, w0 rows staged at once
  int splits3, rows3, chunk3;  // the same for z's 2C rows and w3
  int gram;     // z's sums from the Gram matrix of w3 (no pass of z for them)
  int threads;  // per block: 256, or 512 for a row or cluster block that fills an SM
  int resident; // the row forms: w0 and w3 staged whole, side by side, at the start
  int smem0, smem1, smem2;  // dynamic shared bytes: the one launch or (a); (b); (c)
};

// T: the element type of x, the weights, the vectors and out (float or
// __nv_bfloat16); the workspaces are f32 in both forms
template <typename T>
struct Ops {
  const T *x, *w0, *b0, *g1, *be1, *w3, *b3, *g4, *be4, *scale;
  float *y, *part1, *part2;
  T* out;
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ __forceinline__ int xpitch(const Dims& d, int cols) {
  return round4(cols) + 2 * d.P;
}

// Shared-memory floats of each region: the x tile with its halo, the y
// (then g) tile, the staged weights, the Gram matrix G (hp x hp), u and
// w (hp each) and two sums of b3.
__host__ __device__ __forceinline__ long long x_floats(const Dims& d, int cols) {
  return (long long)d.Cp * xpitch(d, cols);
}
__host__ __device__ __forceinline__ long long g_floats(const Dims& d, int cols) {
  return (long long)d.hp * round4(cols);
}
__host__ __device__ __forceinline__ long long w_floats(const Dims& d, const Plan& p) {
  const long long a = (long long)p.chunk0 * d.K0, b = (long long)p.chunk3 * d.hp;
  return p.resident ? a + b : a > b ? a : b;
}
// conv0's shared partial sums: kTM0 x kTN per thread
__host__ __device__ __forceinline__ int scratch_floats(const Plan& p) {
  return p.threads * kTM0 * kTN;
}
__host__ __device__ __forceinline__ int gram_floats(const Dims& d) {
  return round4(d.hp * d.hp + 2 * d.hp + 2);
}
// (b)'s blocks per row: one per tile with the Gram matrix, else the z splits
__host__ __device__ __forceinline__ int zstats_blocks(const Plan& p) {
  return p.blocks * (p.gram ? 1 : p.splits3);
}

// dynamic shared bytes of the one-launch forms, of (a), (b) and (c)
long long row_bytes(const Dims& d, const Plan& p) {
  return 4 * (x_floats(d, p.cols) + g_floats(d, p.cols) + w_floats(d, p) + d.vec + kRed +
              scratch_floats(p) + (p.gram ? gram_floats(d) : 0));
}
long long conv0_bytes(const Dims& d, const Plan& p) {
  return 4 * (x_floats(d, p.cols) + (long long)p.chunk0 * d.K0 + d.vec + kRed +
              scratch_floats(p));
}
long long zstats_bytes(const Dims& d, const Plan& p) {
  return 4 * (g_floats(d, p.cols) + d.vec + kRed +
              (p.gram ? 2LL * d.C * d.hp + gram_floats(d) : (long long)p.chunk3 * d.hp));
}
long long apply_bytes(const Dims& d, const Plan& p) {
  return 4 * (g_floats(d, p.cols) + (long long)p.chunk3 * d.hp + d.vec + kRed +
              (long long)(p.rows3 / 2) * round4(p.cols));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// this thread's cp.async copies have landed (a __syncthreads() then
// publishes them to the block)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::: "memory");
}

// Staging from device memory into f32 shared memory. stage<W>(n, at)
// copies n items of W elements (1, or 4 from a 4 sizeof(T)-byte aligned
// source to a 16-byte aligned destination); at(i, dst, src) names item
// i's destination and source, or src = null for zeros. f32 goes by
// cp.async, landed at cp_async_wait_all. bf16 has no 2-byte cp.async: it
// is widened through registers (exactly: a bf16 value is the top half of
// an f32), each thread loading kBatch items before it stores any, so that
// kBatch loads are in flight at once. Either way a __syncthreads() after
// cp_async_wait_all() publishes the items to the block.
constexpr int kBatch = 8;

template <int W>
__device__ __forceinline__ void zero(float* dst) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  else
    *dst = 0.f;
}

// the raw bits of W bf16 elements, widened into dst
__device__ __forceinline__ void store_raw(float* dst, unsigned short u) {
  *dst = __uint_as_float((unsigned)u << 16);
}
__device__ __forceinline__ void store_raw(float* dst, uint2 u) {  // element 0 in u.x's low half
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <int W, typename T, class At>
__device__ __forceinline__ void stage(int n, At&& at) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float* dst;
      const float* src = nullptr;
      at(i, dst, src);
      if (!src)
        zero<W>(dst);
      else if constexpr (W == 4)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    }
  } else {
    using Raw = typename std::conditional<W == 4, uint2, unsigned short>::type;
    for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
      float* dst[kBatch];
      Raw raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        const T* src = nullptr;
        dst[u] = nullptr;
        if (i < n) at(i, dst[u], src);
        raw[u] = src ? *reinterpret_cast<const Raw*>(src) : Raw{};
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (dst[u]) store_raw(dst[u], raw[u]);
    }
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// an f32 result as T: itself, or rounded to the nearest even bf16
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// z row R of the interleaved order (a_0, gate_0, a_1, gate_1, ...) is row
// zrow(R) of w3, b3, g4 and be4
__device__ __forceinline__ int zrow(int R, int C) { return (R & 1) ? C + (R >> 1) : R >> 1; }

// The vectors into shared memory: b0, g1, be1 (hp each), b3, g4, be4 (2C
// each, interleaved), scale (Cp); zeros in the padding.
template <typename T>
__device__ void stage_vec(float* vec, const Ops<T>& o, const Dims& d) {
  const int C2 = 2 * d.C, zb = 3 * d.hp, sb = zb + 3 * C2;
  stage<1, T>(d.vec, [&](int i, float*& dst, const T*& src) {
    dst = vec + i;
    if (i < zb) {
      const int k = i / d.hp, j = i - k * d.hp;
      if (j < d.h) src = (k == 0 ? o.b0 : k == 1 ? o.g1 : o.be1) + j;
    } else if (i < sb) {
      const int k = (i - zb) / C2, R = i - zb - k * C2;
      src = (k == 0 ? o.b3 : k == 1 ? o.g4 : o.be4) + zrow(R, d.C);
    } else if (i - sb < d.C) {
      src = o.scale + (i - sb);
    }
  });
}

// xs[c][i] = x[c][t0 - P + i] of the row xr (C, T) for i < xp; zeros
// past the row's ends and in rows C..Cp-1
template <typename T>
__device__ void stage_x(float* xs, const T* __restrict__ xr, const Dims& d, int t0, int xp) {
  const int start = t0 - d.P;  // a multiple of 4, as are T (if vx) and xp
  if (d.vx) {
    const int q = xp >> 2;
    stage<4, T>(d.Cp * q, [&](int i, float*& dst, const T*& src) {
      const int c = i / q, k = (i - c * q) * 4, t = start + k;
      dst = xs + c * xp + k;
      if (c < d.C && t >= 0 && t < d.T) src = xr + (size_t)c * d.T + t;
    });
  } else {
    stage<1, T>(d.Cp * xp, [&](int i, float*& dst, const T*& src) {
      const int c = i / xp, t = start + i - c * xp;
      dst = xs + i;
      if (c < d.C && t >= 0 && t < d.T) src = xr + (size_t)c * d.T + t;
    });
  }
}

// rows [m0, m0 + rows) of w0 (h, C, 3) into ws[r][3 c + k], K0 floats a
// row, zeros for c >= C
template <typename T>
__device__ void stage_w0(float* ws, const T* __restrict__ w0, int m0, int rows,
                         const Dims& d) {
  const int C3 = 3 * d.C;
  const T* w = w0 + (size_t)m0 * C3;
  if (d.vw0) {  // C % 4 == 0, so K0 == C3
    const int q = d.K0 >> 2;
    stage<4, T>(rows * q, [&](int i, float*& dst, const T*& src) {
      const int r = i / q, k = (i - r * q) * 4;
      dst = ws + r * d.K0 + k;
      src = w + (size_t)r * C3 + k;
    });
  } else {
    stage<1, T>(rows * d.K0, [&](int i, float*& dst, const T*& src) {
      const int r = i / d.K0, k = i - r * d.K0;
      dst = ws + i;
      if (k < C3) src = w + (size_t)r * C3 + k;
    });
  }
}

// rows [r0, r0 + rows) of w3 (2C, h) in the interleaved order into
// ws[r][j], hp floats a row, zeros for j >= h
template <typename T>
__device__ void stage_w3(float* ws, const T* __restrict__ w3, int r0, int rows,
                         const Dims& d) {
  if (d.vw3) {  // h % 4 == 0, so hp == h
    const int q = d.hp >> 2;
    stage<4, T>(rows * q, [&](int i, float*& dst, const T*& src) {
      const int r = i / q, k = (i - r * q) * 4;
      dst = ws + r * d.hp + k;
      src = w3 + (size_t)zrow(r0 + r, d.C) * d.h + k;
    });
  } else {
    stage<1, T>(rows * d.hp, [&](int i, float*& dst, const T*& src) {
      const int r = i / d.hp, k = i - r * d.hp;
      dst = ws + i;
      if (k < d.h) src = w3 + (size_t)zrow(r0 + r, d.C) * d.h + k;
    });
  }
}

// gs[j][t] = y[j][t] of the tile yr (cp.async; T floats a row of y) for
// j < h and t < ncols; rows h..hp-1 zero
__device__ void stage_y(float* gs, int gp, const float* __restrict__ yr, const Dims& d,
                        int ncols) {
  for (int i = threadIdx.x; i < d.hp * ncols; i += blockDim.x) {
    const int j = i / ncols, t = i - j * ncols;
    if (j < d.h)
      cp_async4(gs + j * gp + t, yr + (size_t)j * d.T + t);
    else
      gs[j * gp + t] = 0.f;
  }
}

// GELU(GroupNorm1(y)) in place over the tile gs (rows < h, columns <
// ncols); g1 and be1 staged
__device__ void gelu_gn1(float* gs, int gp, const Dims& d, int ncols, float2 st1,
                         const float* g1, const float* be1) {
  for (int i = threadIdx.x; i < d.h * ncols; i += blockDim.x) {
    const int j = i / ncols, t = i - j * ncols;
    float* v = gs + j * gp + t;
    *v = gelu(norm(*v, st1, g1[j], be1[j]));
  }
}

// xs[c][t] = x[c_lo + c][t] of the tile xr (T floats a row) for c <
// rows and t < ncols; xp floats a row
template <typename T>
__device__ void stage_x_rows(float* xs, int xp, const T* __restrict__ xr, int c_lo,
                             int rows, int ncols, const Dims& d) {
  const T* x = xr + (size_t)c_lo * d.T;
  if (d.vx) {  // T, t0 and so ncols are multiples of 4
    const int q = ncols >> 2;
    stage<4, T>(rows * q, [&](int i, float*& dst, const T*& src) {
      const int c = i / q, t = (i - c * q) * 4;
      dst = xs + c * xp + t;
      src = x + (size_t)c * d.T + t;
    });
  } else {
    stage<1, T>(rows * ncols, [&](int i, float*& dst, const T*& src) {
      const int c = i / ncols, t = i - c * ncols;
      dst = xs + c * xp + t;
      src = x + (size_t)c * d.T + t;
    });
  }
}

// GroupNorm2, with b3 before it and LayerScale after it, as one affine
// map per z row: over the staged b3, g4, be4 (interleaved) it writes
// A = rstd g4 (times scale on a rows) over g4 and B = (b3 - mean) A + be4
// (the same) over be4. The caller then publishes them (__syncthreads).
__device__ void fold_gn2(float* vec, const Dims& d, float2 st2) {
  const int C2 = 2 * d.C;
  const float* b3 = vec + 3 * d.hp;
  float *g4 = vec + 3 * d.hp + C2, *be4 = g4 + C2;
  const float* scale = be4 + C2;
  for (int R = threadIdx.x; R < C2; R += blockDim.x) {
    float a = g4[R] * st2.y;
    float b = (b3[R] - st2.x) * a + be4[R];
    if (!(R & 1)) {
      a *= scale[R >> 1];
      b *= scale[R >> 1];
    }
    g4[R] = a;
    be4[R] = b;
  }
}

// For z = W3 g + b3 over the staged rows ws (all 2C, interleaved, hp
// floats a row, zero columns past h) and b3: G = W3^T W3 (hp x hp), u =
// W3^T b3, w = W3^T 1 (hp each), then sum b3 and sum b3^2, into G. Then
// per column sum_o z = w.g + sum b3 and sum_o z^2 = g^T G g + 2 u.g +
// sum b3^2: z's sums without z, at 2C h^2 operations per block and h^2
// per column against 2C h per column for z itself.
__device__ void gram_matrix(float* G, const float* ws, const float* b3, int rows, int hp) {
  const int hh = hp * hp, n = hh + 2 * hp + 2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float a = 0.f;
    if (e < hh) {
      const float *wj = ws + e / hp, *wk = ws + e % hp;
      for (int o = 0; o < rows; ++o) a = fmaf(wj[o * hp], wk[o * hp], a);
    } else if (e < hh + hp) {
      const float* wj = ws + (e - hh);
      for (int o = 0; o < rows; ++o) a = fmaf(wj[o * hp], b3[o], a);
    } else if (e < hh + 2 * hp) {
      const float* wj = ws + (e - hh - hp);
      for (int o = 0; o < rows; ++o) a += wj[o * hp];
    } else if (e == hh + 2 * hp) {
      for (int o = 0; o < rows; ++o) a += b3[o];
    } else {
      for (int o = 0; o < rows; ++o) a = fmaf(b3[o], b3[o], a);
    }
    G[e] = a;
  }
}

// a float4 of shared memory, read where it stands: G's reads in
// gram_sums must not be hoisted out of the loop over columns (all of G
// would not fit in registers)
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// (sum z, sum z^2) over this thread's columns of the g tile gs (gp floats
// a row, t < ncols) from gram_matrix's G
template <int HP>
__device__ float2 gram_sums(const float* gs, int gp, const float* G, int ncols) {
  const float *u = G + HP * HP, *w = u + HP;
  const float sb = w[HP], sb2 = w[HP + 1];
  float s = 0.f, s2 = 0.f;
  for (int t = threadIdx.x; t < ncols; t += blockDim.x) {
    float g[HP];
#pragma unroll
    for (int j = 0; j < HP; ++j) g[j] = gs[j * gp + t];
    float q = 0.f, l = 0.f;
#pragma unroll
    for (int j = 0; j < HP; ++j) {
      float a = 2.f * u[j];
#pragma unroll
      for (int k = 0; k < HP; k += 4) {
        const float4 gk = lds4(G + j * HP + k);
        a = fmaf(gk.x, g[k], a);
        a = fmaf(gk.y, g[k + 1], a);
        a = fmaf(gk.z, g[k + 2], a);
        a = fmaf(gk.w, g[k + 3], a);
      }
      q = fmaf(g[j], a, q);
      l = fmaf(w[j], g[j], l);
    }
    s += l + sb;
    s2 += q + sb2;
  }
  return make_float2(s, s2);
}

constexpr int kMaxGram = 24;  // hp at most for the Gram matrix's sums

__device__ float2 gram_sums(const float* gs, int gp, const float* G, int ncols, int hp) {
  switch (hp) {
    case 4: return gram_sums<4>(gs, gp, G, ncols);
    case 8: return gram_sums<8>(gs, gp, G, ncols);
    case 12: return gram_sums<12>(gs, gp, G, ncols);
    case 16: return gram_sums<16>(gs, gp, G, ncols);
    case 20: return gram_sums<20>(gs, gp, G, ncols);
    default: return gram_sums<24>(gs, gp, G, ncols);
  }
}

// A warp's tile of kWarpCols columns: this lane's kTN columns, 32 apart,
// clamped to ncols - 1 (col) and whether each is one of the block's (ok)
__device__ __forceinline__ void lane_columns(int group, int ncols, int (&col)[kTN],
                                             bool (&ok)[kTN]) {
  const int base = group * kWarpCols + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    ok[j] = base + 32 * j < ncols;
    col[j] = min(base + 32 * j, ncols - 1);
  }
}

// this lane's y - b0 for the warp's tile `item` (y rows r0..r0+5 of the
// staged rows, ws with K0 floats a row; rows past `rows` repeat the last)
// over the input channels [c_lo, c_hi) (multiples of 4), from the x tile
// xs (xp floats a row, column 0 at xs[0], the halo before it)
__device__ __forceinline__ void conv0_acc(float (&acc)[kTM0][kTN], const float* xs, int xp,
                                          int dil, const float* ws, int K0, int r0, int rows,
                                          const int (&col)[kTN], int c_lo, int c_hi) {
  const float* wr[kTM0];
#pragma unroll
  for (int i = 0; i < kTM0; ++i) wr[i] = ws + min(r0 + i, rows - 1) * K0;
#pragma unroll
  for (int i = 0; i < kTM0; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const float* xc = xs + c_lo * xp;
  for (int c = c_lo; c < c_hi; c += 4, xc += 4 * xp) {
    // xv[channel c + u][tap k][column j] = x[c + u][col j + (k - 1) dil]
    float xv[4][3][kTN];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < kTN; ++j) xv[u][k][j] = xc[u * xp + col[j] + (k - 1) * dil];
#pragma unroll
    for (int i = 0; i < kTM0; ++i) {
      // w0[r][c..c+3][0..2]: 12 floats, 16-byte aligned (K0 and c are
      // multiples of 4)
      const float4* w4 = reinterpret_cast<const float4*>(wr[i] + 3 * c);
      const float4 a = w4[0], b = w4[1], e = w4[2];
      const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y, e.z, e.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(w[3 * u + k], xv[u][k][j], acc[i][j]);
    }
  }
}

// conv0 on the staged rows: y[r][t] - b0 for r < rows (ws, K0 floats a
// row) and t < ncols of the x tile xs; epi(r, t, v) takes each output. A
// warp takes tiles of 6 rows by 64 columns. With fewer tiles than warps,
// ks warps share a tile, each summing a part of the channels, and the
// first adds the others' sums (through scratch) in part order.
template <class Epi>
__device__ __forceinline__ void conv0_items(const float* xs, int xp, int dil, const float* ws,
                                            int K0, int Cp, int rows, int ncols, float* scratch,
                                            Epi&& epi) {
  const int groups = (ncols + kWarpCols - 1) / kWarpCols;
  const int items = (rows + kTM0 - 1) / kTM0 * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int col[kTN];
  bool ok[kTN];
  float acc[kTM0][kTN];
  auto emit = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kTM0; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (r0 + i < rows && ok[j]) epi(r0 + i, col[j], acc[i][j]);
  };
  const int warps = blockDim.x >> 5;
  if (items >= warps) {
    for (int item = warp; item < items; item += warps) {
      lane_columns(item % groups, ncols, col, ok);
      conv0_acc(acc, xs, xp, dil, ws, K0, item / groups * kTM0, rows, col, 0, Cp);
      emit(item / groups * kTM0);
    }
    return;
  }
  const int ks = warps / items, quads = Cp / 4, per = (quads + ks - 1) / ks;
  const int item = warp / ks, part = warp - item * ks;
  const bool busy = item < items;
  float* mine = scratch + warp * (kTM0 * kTN * 32) + lane;
  if (busy) {
    lane_columns(item % groups, ncols, col, ok);
    conv0_acc(acc, xs, xp, dil, ws, K0, item / groups * kTM0, rows, col,
              4 * min(part * per, quads), 4 * min((part + 1) * per, quads));
    if (part) {
#pragma unroll
      for (int i = 0; i < kTM0; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) mine[(i * kTN + j) * 32] = acc[i][j];
    }
  }
  __syncthreads();
  if (busy && part == 0) {
    for (int q = 1; q < ks; ++q) {
      const float* theirs = mine + q * (kTM0 * kTN * 32);
#pragma unroll
      for (int i = 0; i < kTM0; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += theirs[(i * kTN + j) * 32];
    }
    emit(item / groups * kTM0);
  }
  __syncthreads();  // scratch is free again
}

// conv1 on the staged rows (an even count, in GLU pairs): z[r][t] - b3
// for r < rows (ws, hp floats a row) and t < ncols of the tile gs (gp
// floats a row). epi(r, col, ok, a, b) takes each pair of rows r (even)
// and r + 1 at this lane's columns col (ok: one of the block's).
template <class Epi>
__device__ __forceinline__ void z_items(const float* gs, int gp, const float* ws, int hp,
                                        int rows, int ncols, Epi&& epi) {
  const int groups = (ncols + kWarpCols - 1) / kWarpCols;
  const int items = (rows + kTM3 - 1) / kTM3 * groups;
  for (int item = threadIdx.x >> 5; item < items; item += blockDim.x >> 5) {
    const int r0 = item / groups * kTM3;
    int col[kTN];
    bool ok[kTN];
    lane_columns(item % groups, ncols, col, ok);
    const float* wr[kTM3];
#pragma unroll
    for (int i = 0; i < kTM3; ++i) wr[i] = ws + min(r0 + i, rows - 1) * hp;
    float acc[kTM3][kTN];
#pragma unroll
    for (int i = 0; i < kTM3; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < hp; k += 4) {
      float gv[4][kTN];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < kTN; ++j) gv[u][j] = gs[(k + u) * gp + col[j]];
#pragma unroll
      for (int i = 0; i < kTM3; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(wr[i] + k);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(w.x, gv[0][j], acc[i][j]);
          acc[i][j] = fmaf(w.y, gv[1][j], acc[i][j]);
          acc[i][j] = fmaf(w.z, gv[2][j], acc[i][j]);
          acc[i][j] = fmaf(w.w, gv[3][j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM3; i += 2)
      if (r0 + i < rows) epi(r0 + i, col, ok, acc[i], acc[i + 1]);
  }
}

// A row's statistics from this block's sums: across the cluster's
// blocks in rank order when the row is split. slot: 4 floats of this
// block's shared memory, the first 2 read by every block of the cluster
// (one lane of warp 0 per rank), the last 2 the row's sums for this
// block. Every block of a cluster gets the same numbers.
__device__ float2 row_moments(float2 tot, float* slot, int cs, float count) {
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      slot[0] = tot.x;
      slot[1] = tot.y;
    }
    cluster.sync();  // barrier.cluster.arrive.release + wait.acquire
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float a = 0.f, b = 0.f;
      if (lane < cs) {
        const float* q = cluster.map_shared_rank(slot, lane);
        a = q[0];
        b = q[1];
      }
      float sa = 0.f, sb = 0.f;
      for (int r = 0; r < cs; ++r) {
        sa += __shfl_sync(kFull, a, r);
        sb += __shfl_sync(kFull, b, r);
      }
      if (lane == 0) {
        slot[2] = sa;
        slot[3] = sb;
      }
    }
    __syncthreads();
    tot = make_float2(slot[2], slot[3]);
  }
  return moments(tot, count);
}

// The "row" and "cluster" forms: grid (cs, N), block r of cluster n takes
// columns [r cols, (r + 1) cols) of row n, with clusters of cs blocks
// along x when cs > 1; 256 or 512 threads. Shared memory: the x slice
// with its halo, y and then g, w0 and w3 (side by side, or a chunk of
// one at a time), the vectors, the scratch, G.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock, 1)
dconv_row_kernel(const Ops<T> o, const Dims d, const Plan p) {
  extern __shared__ float4 smem4[];
  const int xp = xpitch(d, p.cols), gp = round4(p.cols), C2 = 2 * d.C;
  float* xs = reinterpret_cast<float*>(smem4);
  float* gs = xs + d.Cp * xp;
  float* ws = gs + d.hp * gp;
  float* ws3 = p.resident ? ws + d.h * d.K0 : ws;  // w3's rows
  float* vec = ws + w_floats(d, p);
  float* red = vec + d.vec;
  float* scratch = red + kRed;
  float* G = scratch + scratch_floats(p);
  const float *b0 = vec, *g1 = vec + d.hp, *be1 = vec + 2 * d.hp;
  const float *b3 = vec + 3 * d.hp, *A = b3 + C2, *B = A + C2;  // A, B once folded
  const size_t n = blockIdx.y;
  const int t0 = blockIdx.x * p.cols, ncols = min(p.cols, d.T - t0);

  stage_vec(vec, o, d);
  stage_x(xs, o.x + n * d.C * d.T, d, t0, xp);
  if (p.resident) {
    stage_w0(ws, o.w0, 0, d.h, d);
    stage_w3(ws3, o.w3, 0, C2, d);
  }
  const float* xc = xs + d.P;  // column 0 of the slice

  // conv0 -> y in gs, chunk by chunk of w0's rows, and y's sums
  float s = 0.f, s2 = 0.f;
  for (int m0 = 0; m0 < d.h; m0 += p.chunk0) {
    const int rows = min(p.chunk0, d.h - m0);
    if (!p.resident) {
      if (m0) __syncthreads();  // no warp still reads the previous chunk
      stage_w0(ws, o.w0, m0, rows, d);
    }
    cp_async_wait_all();
    __syncthreads();
    conv0_items(xc, xp, d.dil, ws, d.K0, d.Cp, rows, ncols, scratch, [&](int r, int t, float v) {
      v += b0[m0 + r];
      gs[(m0 + r) * gp + t] = v;
      s += v;
      s2 += v * v;
    });
  }
  // (block_sum2's barriers also publish gs)
  const float2 st1 = row_moments(block_sum2(s, s2, red), red + kSlots, p.blocks,
                                 (float)d.h * d.T);

  // GELU(GroupNorm1(y)) in place; rows h..hp-1 zero
  gelu_gn1(gs, gp, d, ncols, st1, g1, be1);
  for (int i = threadIdx.x; i < (d.hp - d.h) * ncols; i += blockDim.x)
    gs[(d.h + i / ncols) * gp + i % ncols] = 0.f;

  // z's sums: from the Gram matrix of w3 (staged whole), or from z, chunk
  // by chunk of w3's rows
  s = s2 = 0.f;
  for (int r0 = 0; r0 < C2; r0 += p.chunk3) {
    const int rows = min(p.chunk3, C2 - r0);
    __syncthreads();  // g is written; no warp still reads w0 or the previous chunk
    if (!p.resident) {
      stage_w3(ws3, o.w3, r0, rows, d);
      cp_async_wait_all();
      __syncthreads();
    }
    if (p.gram) {  // then rows == C2
      gram_matrix(G, ws3, b3, C2, d.hp);
      __syncthreads();
      const float2 sums = gram_sums(gs, gp, G, ncols, d.hp);
      s = sums.x;
      s2 = sums.y;
    } else {
      z_items(gs, gp, ws3, d.hp, rows, ncols, [&](int r, const int(&)[kTN], const bool (&ok)[kTN],
                                                  const float (&a)[kTN], const float (&b)[kTN]) {
        const float ba = b3[r0 + r], bb = b3[r0 + r + 1];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          if (!ok[j]) continue;
          const float u = a[j] + ba, v = b[j] + bb;
          s += u;
          s2 += u * u;
          s += v;
          s2 += v * v;
        }
      });
    }
  }
  const float2 st2 = row_moments(block_sum2(s, s2, red), red + kSlots + 4, p.blocks,
                                 2.f * d.C * d.T);
  fold_gn2(vec, d, st2);
  __syncthreads();

  // z again: GroupNorm2, GLU, LayerScale and the residual -> out (a single
  // chunk of w3 is still staged)
  T* outr = o.out + n * d.C * d.T + t0;
  for (int r0 = 0; r0 < C2; r0 += p.chunk3) {
    const int rows = min(p.chunk3, C2 - r0);
    if (p.chunk3 < C2) {
      __syncthreads();
      stage_w3(ws3, o.w3, r0, rows, d);
      cp_async_wait_all();
      __syncthreads();
    }
    z_items(gs, gp, ws3, d.hp, rows, ncols, [&](int r, const int (&col)[kTN],
                                                const bool (&ok)[kTN], const float (&a)[kTN],
                                                const float (&b)[kTN]) {
      const int R = r0 + r, c = R >> 1;
      const float Aa = A[R], Ba = B[R], Ag = A[R + 1], Bg = B[R + 1];
      T* o_row = outr + (size_t)c * d.T;
      const float* x_row = xc + c * xp;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (ok[j])
          o_row[col[j]] =
              narrow<T>(x_row[col[j]] + fmaf(a[j], Aa, Ba) * gate(fmaf(b[j], Ag, Bg)));
    });
  }
  // no block leaves while another may still read its slots
  if (p.blocks > 1) cg::this_cluster().sync();
}

// "tiles" (a): grid (tiles x splits0, N); block (tile, split) takes y
// rows [split rows0, ...) of one tile: y into the workspace, its sums
// into part1[n][block].
template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
dconv_tile_conv0_kernel(const Ops<T> o, const Dims d, const Plan p) {
  extern __shared__ float4 smem4[];
  const int xp = xpitch(d, p.cols);
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + d.Cp * xp;
  float* vec = ws + p.chunk0 * d.K0;
  float* red = vec + d.vec;
  float* scratch = red + kRed;
  const size_t n = blockIdx.y;
  const int tile = blockIdx.x / p.splits0, split = blockIdx.x - tile * p.splits0;
  const int t0 = tile * p.cols, ncols = min(p.cols, d.T - t0);
  const int m_lo = split * p.rows0, m_hi = min(d.h, m_lo + p.rows0);

  stage_vec(vec, o, d);
  stage_x(xs, o.x + n * d.C * d.T, d, t0, xp);
  float* yr = o.y + n * d.h * d.T + t0;
  float s = 0.f, s2 = 0.f;
  for (int m0 = m_lo; m0 < m_hi; m0 += p.chunk0) {
    const int rows = min(p.chunk0, m_hi - m0);
    if (m0 > m_lo) __syncthreads();
    stage_w0(ws, o.w0, m0, rows, d);
    cp_async_wait_all();
    __syncthreads();
    conv0_items(xs + d.P, xp, d.dil, ws, d.K0, d.Cp, rows, ncols, scratch,
                [&](int r, int t, float v) {
      v += vec[m0 + r];
      yr[(size_t)(m0 + r) * d.T + t] = v;
      s += v;
      s2 += v * v;
    });
  }
  const float2 tot = block_sum2(s, s2, red);
  if (threadIdx.x == 0) {
    float* q = o.part1 + (n * gridDim.x + blockIdx.x) * 2;
    q[0] = tot.x;
    q[1] = tot.y;
  }
}

// "tiles" (b): z's sums into part2[n][block]. With the Gram matrix, grid
// (tiles, N) and all 2C rows per block; else grid (tiles x splits3, N),
// block (tile, split) taking z rows [split rows3, ...) (interleaved GLU
// pairs) of one tile.
template <typename T>
__global__ void __launch_bounds__(kBlock, 3)
dconv_tile_zstats_kernel(const Ops<T> o, const Dims d, const Plan p) {
  extern __shared__ float4 smem4[];
  const int gp = round4(p.cols), C2 = 2 * d.C;
  const int splits = p.gram ? 1 : p.splits3;
  float* gs = reinterpret_cast<float*>(smem4);
  float* ws = gs + d.hp * gp;
  float* vec = ws + (p.gram ? C2 : p.chunk3) * d.hp;
  float* red = vec + d.vec;
  float* G = red + kRed;
  const float* b3 = vec + 3 * d.hp;
  const size_t n = blockIdx.y;
  const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
  const int t0 = tile * p.cols, ncols = min(p.cols, d.T - t0);

  // the copies first, the statistics while they land
  stage_vec(vec, o, d);
  stage_y(gs, gp, o.y + n * d.h * d.T + t0, d, ncols);
  if (p.gram) stage_w3(ws, o.w3, 0, C2, d);
  const int parts1 = p.blocks * p.splits0;
  const float2 st1 = row_stats(o.part1 + n * parts1 * 2, parts1, (float)d.h * d.T, red);
  cp_async_wait_all();
  __syncthreads();
  gelu_gn1(gs, gp, d, ncols, st1, vec + d.hp, vec + 2 * d.hp);
  float s = 0.f, s2 = 0.f;
  if (p.gram) {
    gram_matrix(G, ws, b3, C2, d.hp);
    __syncthreads();
    const float2 sums = gram_sums(gs, gp, G, ncols, d.hp);
    s = sums.x;
    s2 = sums.y;
  } else {
    const int r_lo = split * p.rows3, r_hi = min(C2, r_lo + p.rows3);
    for (int r0 = r_lo; r0 < r_hi; r0 += p.chunk3) {
      const int rows = min(p.chunk3, r_hi - r0);
      __syncthreads();  // g is written; no warp still reads the previous chunk
      stage_w3(ws, o.w3, r0, rows, d);
      cp_async_wait_all();
      __syncthreads();
      z_items(gs, gp, ws, d.hp, rows, ncols, [&](int r, const int(&)[kTN], const bool (&ok)[kTN],
                                                 const float (&a)[kTN], const float (&b)[kTN]) {
        const float ba = b3[r0 + r], bb = b3[r0 + r + 1];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          if (!ok[j]) continue;
          const float u = a[j] + ba, v = b[j] + bb;
          s += u;
          s2 += u * u;
          s += v;
          s2 += v * v;
        }
      });
    }
  }
  const float2 tot = block_sum2(s, s2, red);
  if (threadIdx.x == 0) {
    float* q = o.part2 + (n * gridDim.x + blockIdx.x) * 2;
    q[0] = tot.x;
    q[1] = tot.y;
  }
}

// "tiles" (c): grid (tiles x splits3, N); block (tile, split) writes the
// out rows of z rows [split rows3, ...) of one tile. Its x rows are
// copied in (cp.async) while it reduces the statistics and stages g.
template <typename T>
__global__ void __launch_bounds__(kBlock, 3)
dconv_tile_apply_kernel(const Ops<T> o, const Dims d, const Plan p) {
  extern __shared__ float4 smem4[];
  const int gp = round4(p.cols), C2 = 2 * d.C;
  float* gs = reinterpret_cast<float*>(smem4);
  float* ws = gs + d.hp * gp;
  float* vec = ws + p.chunk3 * d.hp;
  float* red = vec + d.vec;
  float* xs = red + kRed;  // (rows3 / 2) x gp
  const float *A = vec + 3 * d.hp + C2, *B = A + C2;  // once folded
  const size_t n = blockIdx.y;
  const int tile = blockIdx.x / p.splits3, split = blockIdx.x - tile * p.splits3;
  const int t0 = tile * p.cols, ncols = min(p.cols, d.T - t0);
  const int r_lo = split * p.rows3, r_hi = min(C2, r_lo + p.rows3);

  // the copies first, the statistics while they land
  stage_x_rows(xs, gp, o.x + n * d.C * d.T + t0, r_lo >> 1, (r_hi - r_lo) >> 1, ncols, d);
  stage_vec(vec, o, d);
  stage_y(gs, gp, o.y + n * d.h * d.T + t0, d, ncols);
  const int parts1 = p.blocks * p.splits0, parts2 = zstats_blocks(p);
  const float2 st1 = row_stats(o.part1 + n * parts1 * 2, parts1, (float)d.h * d.T, red);
  const float2 st2 = row_stats(o.part2 + n * parts2 * 2, parts2, 2.f * d.C * d.T, red);
  cp_async_wait_all();
  __syncthreads();
  gelu_gn1(gs, gp, d, ncols, st1, vec + d.hp, vec + 2 * d.hp);
  fold_gn2(vec, d, st2);
  T* outr = o.out + n * d.C * d.T + t0;
  for (int r0 = r_lo; r0 < r_hi; r0 += p.chunk3) {
    const int rows = min(p.chunk3, r_hi - r0);
    __syncthreads();  // g, A, B are written; no warp still reads the previous chunk
    stage_w3(ws, o.w3, r0, rows, d);
    cp_async_wait_all();
    __syncthreads();
    z_items(gs, gp, ws, d.hp, rows, ncols, [&](int r, const int (&col)[kTN],
                                               const bool (&ok)[kTN], const float (&a)[kTN],
                                               const float (&b)[kTN]) {
      const int R = r0 + r, c = R >> 1;
      const float Aa = A[R], Ba = B[R], Ag = A[R + 1], Bg = B[R + 1];
      T* o_row = outr + (size_t)c * d.T;
      const float* x_row = xs + (c - (r_lo >> 1)) * gp;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (ok[j])
          o_row[col[j]] =
              narrow<T>(x_row[col[j]] + fmaf(a[j], Aa, Ba) * gate(fmaf(b[j], Ag, Bg)));
    });
  }
}

// whether ptr can be read 4 elements of T at a time
template <typename T>
bool aligned4(const T* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0;
}

// true if the kernels can run plan p at shape d: the same sizes as the
// host's dconv_plan computes, every block of a row busy, the shared
// memory within one block's
bool check_plan(const Dims& d, const Plan& p) {
  if (d.N < 1 || d.N > 65535 || d.C < 1 || d.h < 1 || d.T < 1 || d.dil < 1 || d.dil > 1024)
    return false;
  if ((long long)d.Cp * d.T >= (1LL << 31) || (long long)d.hp * d.T >= (1LL << 31)) return false;
  if (p.cols < 4 || p.cols % 4 || p.chunk0 < 1 || p.chunk0 > p.rows0 || p.chunk3 < 2 ||
      p.chunk3 % 2 || p.chunk3 > p.rows3 || p.gram < 0 || p.gram > 1 ||
      (p.gram && d.hp > kMaxGram) || p.resident < 0 || p.resident > 1)
    return false;
  long long a, b, c;
  if (p.form == kRowForm) {
    if (p.blocks > kMaxCluster || p.splits0 != 1 || p.splits3 != 1 || p.rows0 != d.h ||
        p.rows3 != 2 * d.C || (p.gram && p.chunk3 != p.rows3) || p.smem1 || p.smem2 ||
        (p.threads != kBlock && p.threads != kMaxBlock) ||
        (p.resident && (p.chunk0 != p.rows0 || p.chunk3 != p.rows3)))
      return false;
    a = row_bytes(d, p);
    b = c = 0;
  } else if (p.form == kTileForm) {
    if (p.splits0 < 1 || p.rows0 < 1 || (long long)(p.splits0 - 1) * p.rows0 >= d.h ||
        (long long)p.splits0 * p.rows0 < d.h || p.splits3 < 1 || p.rows3 < 2 || p.rows3 % 2 ||
        (long long)(p.splits3 - 1) * p.rows3 >= 2 * d.C ||
        (long long)p.splits3 * p.rows3 < 2 * d.C ||
        (long long)p.blocks * (p.splits0 > p.splits3 ? p.splits0 : p.splits3) > 0x7fffffffLL ||
        p.threads != kBlock || p.resident)
      return false;
    a = conv0_bytes(d, p);
    b = zstats_bytes(d, p);
    c = apply_bytes(d, p);
  } else {
    return false;
  }
  return a == p.smem0 && b == p.smem1 && c == p.smem2 && a <= kSmemLimit && b <= kSmemLimit &&
         c <= kSmemLimit;
}

// every K5 kernel may take all of a block's shared memory; once
cudaError_t allow_shared_memory() {
  static std::once_flag once;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    const void* kernels[] = {(const void*)dconv_row_kernel<float>,
                             (const void*)dconv_tile_conv0_kernel<float>,
                             (const void*)dconv_tile_zstats_kernel<float>,
                             (const void*)dconv_tile_apply_kernel<float>,
                             (const void*)dconv_row_kernel<__nv_bfloat16>,
                             (const void*)dconv_tile_conv0_kernel<__nv_bfloat16>,
                             (const void*)dconv_tile_zstats_kernel<__nv_bfloat16>,
                             (const void*)dconv_tile_apply_kernel<__nv_bfloat16>};
    for (const void* k : kernels) {
      const cudaError_t e =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (e != cudaSuccess && err == cudaSuccess) err = e;
    }
  });
  return err;
}

// ---- K4 -------------------------------------------------------------------

// partial sums of one kChunk-element chunk of a row of x (R, 2C, T);
// grid (chunks, R), kThreads threads
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_glu_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int row_len) {
  __shared__ float red[2 * kThreads / 32];
  const T* xr = x + (size_t)blockIdx.y * row_len;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kChunk + k * kThreads + threadIdx.x;
    if (i < row_len) {
      const float v = widen(xr[i]);
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
template <typename E>
__global__ void __launch_bounds__(kThreads)
gn_glu_apply_kernel(const E* __restrict__ x, const E* __restrict__ weight,
                    const E* __restrict__ bias, const E* __restrict__ scale,
                    const E* __restrict__ res, const float* __restrict__ part,
                    E* __restrict__ out, int n_parts, int C, int T) {
  __shared__ float red[2 * kThreads / 32];
  const int row_len = C * T;
  const size_t r = blockIdx.y;
  const float2 st = row_stats(part + r * n_parts * 2, n_parts, 2.f * row_len, red);
  const E* xr = x + r * 2 * row_len;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kChunk + k * kThreads + threadIdx.x;
    if (i < row_len) {
      const int c = i / T;
      const float an = norm(widen(xr[i]), st, widen(weight[c]), widen(bias[c]));
      const float gn =
          norm(widen(xr[row_len + i]), st, widen(weight[C + c]), widen(bias[C + c]));
      out[r * row_len + i] =
          narrow<E>(widen(res[r * row_len + i]) + an * sigmoid(gn) * widen(scale[c]));
    }
  }
}

// K5 in element type T: the entry points' body
template <typename T>
cudaError_t launch_dconv(const void* x, const void* w0, const void* b0, const void* g1,
                         const void* be1, const void* w3, const void* b3, const void* g4,
                         const void* be4, const void* scale, void* y, void* part1, void* part2,
                         void* out, int N, int C, int h, int T_, int dil, int form, int cols,
                         int splits0, int rows0, int chunk0, int splits3, int rows3, int chunk3,
                         int gram, int threads, int resident, int smem0, int smem1, int smem2,
                         cudaStream_t stream) {
  const Ops<T> o = {static_cast<const T*>(x),     static_cast<const T*>(w0),
                    static_cast<const T*>(b0),    static_cast<const T*>(g1),
                    static_cast<const T*>(be1),   static_cast<const T*>(w3),
                    static_cast<const T*>(b3),    static_cast<const T*>(g4),
                    static_cast<const T*>(be4),   static_cast<const T*>(scale),
                    static_cast<float*>(y),       static_cast<float*>(part1),
                    static_cast<float*>(part2),   static_cast<T*>(out)};
  Dims d;
  d.N = N, d.C = C, d.h = h, d.T = T_, d.dil = dil;
  d.Cp = round4(C), d.hp = round4(h), d.P = round4(dil), d.K0 = 3 * d.Cp;
  d.vec = round4(3 * d.hp + 6 * C + d.Cp);
  d.vx = T_ % 4 == 0 && aligned4(o.x);
  d.vw0 = C % 4 == 0 && aligned4(o.w0);
  d.vw3 = h % 4 == 0 && aligned4(o.w3);
  Plan p;
  p.form = form, p.cols = cols, p.blocks = cols > 0 ? (T_ + cols - 1) / cols : 0;
  p.splits0 = splits0, p.rows0 = rows0, p.chunk0 = chunk0;
  p.splits3 = splits3, p.rows3 = rows3, p.chunk3 = chunk3, p.gram = gram;
  p.threads = threads, p.resident = resident;
  p.smem0 = smem0, p.smem1 = smem1, p.smem2 = smem2;
  if (!check_plan(d, p)) return cudaErrorInvalidValue;
  if (form == kTileForm && (!y || !part1 || !part2)) return cudaErrorInvalidValue;
  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(p.threads);
  cfg.stream = stream;
  if (form == kRowForm) {
    cudaLaunchAttribute attr;
    cfg.gridDim = dim3(p.blocks, N);
    cfg.dynamicSmemBytes = p.smem0;
    if (p.blocks > 1) {
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = p.blocks;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
    }
    err = cudaLaunchKernelEx(&cfg, dconv_row_kernel<T>, o, d, p);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  cfg.gridDim = dim3(p.blocks * p.splits0, N);
  cfg.dynamicSmemBytes = p.smem0;
  err = cudaLaunchKernelEx(&cfg, dconv_tile_conv0_kernel<T>, o, d, p);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(zstats_blocks(p), N);
  cfg.dynamicSmemBytes = p.smem1;
  err = cudaLaunchKernelEx(&cfg, dconv_tile_zstats_kernel<T>, o, d, p);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(p.blocks * p.splits3, N);
  cfg.dynamicSmemBytes = p.smem2;
  err = cudaLaunchKernelEx(&cfg, dconv_tile_apply_kernel<T>, o, d, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K4 in element type E
template <typename E>
cudaError_t launch_gn_glu(const void* x, const void* weight, const void* bias, const void* scale,
                          const void* res, void* part, void* out, int R, int C, int T,
                          cudaStream_t s) {
  if (R < 1 || R > 65535 || C < 1 || T < 1 || (long long)2 * C * T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int row_len = 2 * C * T;
  const int n_parts = (row_len + kChunk - 1) / kChunk;
  const E* xe = static_cast<const E*>(x);
  float* p = static_cast<float*>(part);
  gn_glu_stats_kernel<E><<<dim3(n_parts, R), kThreads, 0, s>>>(xe, p, row_len);
  gn_glu_apply_kernel<E><<<dim3((C * T + kChunk - 1) / kChunk, R), kThreads, 0, s>>>(
      xe, static_cast<const E*>(weight), static_cast<const E*>(bias),
      static_cast<const E*>(scale), static_cast<const E*>(res), p, static_cast<E*>(out),
      n_parts, C, T);
  return cudaGetLastError();
}

}  // namespace

// K5. x, out (N, C, T); w0 (h, C, 3); b0, g1, be1 (h); w3 (2C, h); b3, g4,
// be4 (2C); scale (C), all f32 (dconv_sub_block_f32) or all bf16
// (dconv_sub_block_bf16) and contiguous; out must not alias x. The plan
// (form, cols, splits0, rows0, chunk0, splits3, rows3, chunk3, gram,
// threads, resident, smem0, smem1, smem2) is ops/cuda/dconv.py:dconv_plan's,
// the same in both forms. The "tiles" form also takes the f32 workspaces y
// (N, h, T), part1 (N, tiles x splits0, 2) and part2 (N, tiles x (1 if gram
// else splits3), 2); the one-launch forms take none (null pointers).
#define DCONV_ENTRY(NAME, TYPE)                                                                  \
  extern "C" int NAME(const void* x, const void* w0, const void* b0, const void* g1,           \
                      const void* be1, const void* w3, const void* b3, const void* g4,         \
                      const void* be4, const void* scale, void* y, void* part1, void* part2,   \
                      void* out, int N, int C, int h, int T, int dil, int form, int cols,      \
                      int splits0, int rows0, int chunk0, int splits3, int rows3, int chunk3,  \
                      int gram, int threads, int resident, int smem0, int smem1, int smem2,    \
                      void* stream) {                                                          \
    return (int)launch_dconv<TYPE>(x, w0, b0, g1, be1, w3, b3, g4, be4, scale, y, part1,       \
                                   part2, out, N, C, h, T, dil, form, cols, splits0, rows0,    \
                                   chunk0, splits3, rows3, chunk3, gram, threads, resident,    \
                                   smem0, smem1, smem2, static_cast<cudaStream_t>(stream));    \
  }
DCONV_ENTRY(dconv_sub_block_f32, float)
DCONV_ENTRY(dconv_sub_block_bf16, __nv_bfloat16)

// How many clusters of cs row-form blocks (threads each, smem dynamic
// shared bytes) the card runs at once (cudaOccupancyMaxActiveClusters),
// or minus a CUDA error.
extern "C" int dconv_cluster_capacity(int cs, int threads, int smem) {
  if (cs < 1 || cs > kMaxCluster || (threads != kBlock && threads != kMaxBlock) || smem < 0 ||
      smem > kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)dconv_row_kernel<float>, &cfg);
  return err != cudaSuccess ? -(int)err : clusters;
}

// K4. x (R, 2C, T); weight, bias (2C); scale (C); res, out (R, C, T), all
// f32 (gn_glu_scale_res_f32) or all bf16 (gn_glu_scale_res_bf16); the f32
// workspace part (R, ceil(2 C T / 2048), 2); all contiguous.
extern "C" int gn_glu_scale_res_f32(const void* x, const void* weight, const void* bias,
                                    const void* scale, const void* res, void* part, void* out,
                                    int R, int C, int T, void* stream) {
  return (int)launch_gn_glu<float>(x, weight, bias, scale, res, part, out, R, C, T,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int gn_glu_scale_res_bf16(const void* x, const void* weight, const void* bias,
                                     const void* scale, const void* res, void* part, void* out,
                                     int R, int C, int T, void* stream) {
  return (int)launch_gn_glu<__nv_bfloat16>(x, weight, bias, scale, res, part, out, R, C, T,
                                           static_cast<cudaStream_t>(stream));
}

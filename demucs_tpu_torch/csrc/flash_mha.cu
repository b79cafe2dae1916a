// Flash (online-softmax) multi-head attention forward on Hopper's tensor
// cores (sm_90a: wgmma, mbarriers).
//
// Two kernels share one body:
//   * mha_fwd_kernel (K1, inference) replaces the Pallas TPU kernel
//     demucs_tpu/ops/pallas/attention.py:flash_mha (_mha_kernel);
//   * mha_fwd_lse_kernel (K2, training) replaces flash_mha_fwd
//     (_mha_fwd_lse_kernel): the same output plus one f32 value per row,
//     lse = m + log(l), the natural-log logsumexp of the *scaled* logits,
//     which the backward (flash_mha_bwd.cu) rebuilds P from.
// Same maths: non-causal attention of q (BH, T, D) over k, v (BH, S, D),
// D in {48, 64}, softmax at 1/sqrt(D), with an f32 running max, running
// sum and accumulator, so the (T, S) logits never reach device memory.
//
// What bounds it: at the Demucs shapes (T, S in {1344, 2688}) the work is
// 4*T*S*D flops against 4*T*D + 4*S*D elements moved, hundreds of flops
// per byte, so arithmetic. The two products run on the tensor cores:
//   * f32 operands as 3xTF32: each operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi), each rounded to nearest as
//     cvt.rna.tf32.f32 rounds (the tensor core reads only the top 19 bits
//     of a register, so an unrounded hi would be truncated; two integer
//     operations do it, which measured 5% faster than the cvt on an
//     H100), and each product is lo.hi + hi.lo + hi.hi with f32
//     accumulation. That keeps about f32 accuracy (relative error ~2^-21
//     per product, against TF32's 2^-11) at a third of the TF32 rate: the
//     bound is 3 x 4*T*S*D flops at 495 TFLOP/s (about 165 TFLOP/s of
//     useful work, against 67 TFLOP/s for f32 FMAs on the CUDA cores);
//   * bf16 operands natively (m64nNk16), with P rounded to bf16 before
//     P.V, as the TPU kernel rounds p.astype(v.dtype): 4*T*S*D flops at
//     989 TFLOP/s.
//
// Design (one block = 3 warpgroups, 384 threads, 128 query rows):
//   * warpgroups 0 and 1 are consumers, 64 query rows each. Each loads
//     its Q tile once into shared memory (split into hi and lo for f32)
//     and per 64-key tile issues S = Q.K^T as wgmma m64n64 with both
//     operands in shared memory and f32 accumulators in registers;
//   * the online softmax runs on the accumulator registers in the log2
//     domain (the scale log2(e)/sqrt(D) applied to S in f32, exp2f); a
//     row's max is reduced over the 4 threads of a quad that share it,
//     its sum stays a per-thread partial until the end;
//   * P feeds O += P.V from registers (the A operand) and never reaches
//     shared or device memory. For bf16 the accumulator's pairs are the
//     A fragment as they are. For tf32 the A fragment wants columns t and
//     t+4 where the accumulator holds 2t and 2t+1, so the keys of every
//     8-key step are permuted instead of the registers: A's column c is key
//     2c (c < 4) or 2(c-4)+1, and V^T's columns are stored in that order;
//   * warpgroup 2 is the producer: for each 64-key tile it reads K and V
//     from device memory (16-byte loads), writes K (keys x D) and V^T
//     (D x keys) into the K-major layout the descriptors describe (split
//     into hi and lo for f32: tf32 wgmma reads only K-major operands, so
//     V has to be transposed anyway), and signals a `full` mbarrier. The
//     ring has 2 stages, each freed by an `empty` mbarrier once both
//     consumers' wgmmas on it have completed, so the next tile's loads
//     overlap this tile's products and softmax. The V^T writes rotate
//     which of its 4 columns each lane writes first, so that the 8 lanes
//     of a 16-byte store phase hit 8 distinct bank groups;
//   * shared memory (f32, D = 64): Q 2 x 2 x 16 KB + 2 stages x (K, V^T)
//     x (hi, lo) x 16 KB = 192 KB, so one block per SM. Q stays in shared
//     memory: holding it in registers as S's A operand, with setmaxnreg
//     handing the producer's registers to the consumers, measured 23%
//     slower on an H100 (ptxas kept 168 registers and spilled);
//   * launch shape: 128 rows per block keeps the K/V traffic per row at
//     half a 64-row block's, and the grid at (2, 8, 2688) is 21 x 16 = 336
//     blocks, 2.5 waves over 132 SMs; at (1, 8, 1344) it is 11 x 8 = 88;
//   * the ragged edges: rows >= T are loaded as zeros, computed and not
//     stored; keys >= S are loaded as zeros (V^T too, so 0 x garbage
//     never arises) and masked to -inf before the max;
//   * K2 only: the running max m2 and sum l are in the log2 domain, so
//     the row's natural-log lse is (m2 + log2 l) * ln 2. No atomics and no
//     order that depends on scheduling: the result is the same bits on
//     every call.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;                   // query rows per consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups per block
constexpr int kBlockRows = kRows * kConsumers;
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kStages = 2;                  // K/V ring
constexpr int kThreads = 128 * (kConsumers + 1);

// shared-memory layout of one (T, D) instantiation; every tile is K-major
// in the canonical layout of sm90.cuh
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kParts = kF32 ? 2 : 1;         // hi, lo
  static constexpr int kElems = 16 / sizeof(T);       // elements per 16-byte chunk
  static constexpr int kRowChunks = D / kElems;       // chunks along D (Q, K)
  static constexpr int kRowSbo = kRowChunks * 128;    // Q, K: bytes per 8 rows
  static constexpr int kRowTile = 64 * D * (int)sizeof(T);
  static constexpr int kVtChunks = kKeys / kElems;    // chunks along the keys (V^T)
  static constexpr int kVtSbo = kVtChunks * 128;
  static constexpr int kVtTile = D * kKeys * (int)sizeof(T);
  static constexpr int kQBytes = kConsumers * kParts * kRowTile;
  static constexpr int kStage = kParts * (kRowTile + kVtTile);  // K parts, then V^T parts
  static constexpr int kBars = kQBytes + kStages * kStage;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

// rows [0, n_valid) of a (64, D) row-major tile of src (zeros past
// n_valid) into dst, K-major along D; f32 as hi at dst, lo at dst +
// kRowTile. `tid` is the thread's index in its warpgroup.
template <typename T, int D>
__device__ __forceinline__ void load_rows(char* dst, const T* src, int n_valid, int tid) {
  using L = Smem<T, D>;
  constexpr int C = L::kRowChunks;
  for (int idx = tid; idx < 64 * C; idx += 128) {
    // lanes walk 8 rows, then the chunks: 8 rows x 64 bytes per warp read,
    // and each 8-lane store phase fills one 128-byte core matrix
    const int r8 = idx & 7, c = (idx >> 3) % C, r = (idx / (8 * C)) * 8 + r8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) x = sm90::load16(reinterpret_cast<const char*>(src + (size_t)r * D) + 16 * c);
    const int off = sm90::kmajor_offset(r, c, L::kRowSbo);
    if constexpr (L::kF32) {
      uint4 hi, lo;
      sm90::split4(x, hi, lo);
      sm90::store16(dst + off, hi);
      sm90::store16(dst + L::kRowTile + off, lo);
    } else {
      sm90::store16(dst + off, x);
    }
  }
}

// rows [0, n_valid) of a (64 keys, D) row-major V tile (zeros past
// n_valid) into dst as V^T (D, 64 keys), K-major along the keys; f32 with
// the keys of every 8 permuted (chunk 0 keys 0, 2, 4, 6, chunk 1 keys 1,
// 3, 5, 7) and split into hi and lo (lo at dst + kVtTile)
template <typename T, int D>
__device__ __forceinline__ void load_vt(char* dst, const T* src, int n_valid, int tid) {
  using L = Smem<T, D>;
  constexpr int DQ = D / 4;  // groups of 4 columns
  for (int idx = tid; idx < (kKeys / 8) * DQ; idx += 128) {
    const int dq = idx % DQ, kg = idx / DQ;
    // lanes dq and dq + 2 write their 4 rows of V^T in rotated order, so
    // the rows 4 dq + ((e + rot) & 3) of 8 neighbouring lanes differ mod 8
    const int rot = (dq >> 1) & 3;
    if constexpr (L::kF32) {
      uint4 x[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int key = 8 * kg + m;
        x[m] = key < n_valid ? sm90::load16(src + (size_t)key * D + 4 * dq)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (e + rot) & 3, d = 4 * dq + col;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 v = make_uint4(sm90::pick(x[half], col), sm90::pick(x[half + 2], col),
                                     sm90::pick(x[half + 4], col), sm90::pick(x[half + 6], col));
          uint4 hi, lo;
          sm90::split4(v, hi, lo);
          const int off = sm90::kmajor_offset(d, 2 * kg + half, L::kVtSbo);
          sm90::store16(dst + off, hi);
          sm90::store16(dst + L::kVtTile + off, lo);
        }
      }
    } else {
      uint2 x[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int key = 8 * kg + m;
        x[m] = key < n_valid ? *reinterpret_cast<const uint2*>(src + (size_t)key * D + 4 * dq)
                             : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (e + rot) & 3, d = 4 * dq + col;
        uint32_t h[8];  // element col of each of the 8 keys
#pragma unroll
        for (int m = 0; m < 8; ++m)
          h[m] = ((col < 2 ? x[m].x : x[m].y) >> (16 * (col & 1))) & 0xFFFFu;
        sm90::store16(dst + sm90::kmajor_offset(d, kg, L::kVtSbo),
                make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                           h[6] | (h[7] << 16)));
      }
    }
  }
}

template <typename T, int D, bool kLse>
__device__ __forceinline__ void mha_fwd_body(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ o,
                                             float* __restrict__ lse, int t_len, int s_len,
                                             float scale_log2) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y;
  const int n_tiles = (s_len + kKeys - 1) / kKeys;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 128);                 // the producer's threads
      sm90::mbar_init(&empty[s], 128 * kConsumers);   // every consumer thread
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: K and V^T tiles into the ring
    const T* kb = k + (size_t)bh * s_len * D;
    const T* vb = v + (size_t)bh * s_len * D;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
      char* stage = smem + L::kQBytes + st * L::kStage;
      const int s0 = it * kKeys, nk = s_len - s0;
      load_rows<T, D>(stage, kb + (size_t)s0 * D, nk, tid);
      load_vt<T, D>(stage + L::kParts * L::kRowTile, vb + (size_t)s0 * D, nk, tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[st]);
    }
    return;
  }

  // consumer warpgroup wg: query rows row0 .. row0 + 63
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int row0 = blockIdx.x * kBlockRows + wg * kRows;
  char* qs = smem + wg * L::kParts * L::kRowTile;  // Q tiles first
  load_rows<T, D>(qs, q + ((size_t)bh * t_len + min(row0, t_len)) * D, t_len - row0, tid);
  sm90::fence_proxy_async();
  sm90::named_barrier(1 + wg, 128);
  // Q's descriptor (f32: its hi part; lo is kRowTile further on)
  const uint64_t dq = sm90::make_desc(sm90::smem_addr(qs), L::kRowSbo);

  constexpr int kO = D / 2;  // accumulator registers of the (64, D) output
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (log2 domain; finite,
  // so exp2f(m - m_new) is 0, not NaN) and this thread's partial sum
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    sm90::mbar_wait(&full[st], (it / kStages) & 1);
    char* stage = smem + L::kQBytes + st * L::kStage;
    const uint32_t ks = sm90::smem_addr(stage);
    const uint32_t vs = ks + L::kParts * L::kRowTile;

    // S = Q K^T (64 x 64 keys, f32)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::wgmma_fence();
    const uint64_t dk = sm90::make_desc(ks, L::kRowSbo);
    if constexpr (L::kF32) {
      // lo.hi and hi.lo first, the largest term last; `+ kRowTile / 16`
      // moves a descriptor from the hi part to the lo part
      constexpr int kLo = L::kRowTile / 16;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        sm90::wgmma_ss_tf32_n64(s, dq + kLo + 16 * kk, dk + 16 * kk, kk > 0);
        sm90::wgmma_ss_tf32_n64(s, dq + 16 * kk, dk + kLo + 16 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        sm90::wgmma_ss_tf32_n64(s, dq + 16 * kk, dk + 16 * kk, 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_bf16_n64(s, dq + 16 * kk, dk + 16 * kk, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<32>(s);

    // online softmax on the accumulator: s[4j + 2h + e] is row g + 8h,
    // key 8j + 2t + e of the tile
    const int s0 = it * kKeys;
    float mx[2] = {m[0], m[1]};
    if (s0 + kKeys <= s_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = s0 + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = key < s_len ? s[i] * scale_log2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
    // this tile's P V, in a fresh accumulator: the tensor core's f32
    // accumulation truncates, so a running sum over all S / 64 tiles would
    // drift (3e-5 of scale at S = 2688 on an H100); the tiles are summed
    // below with rounded FMAs instead
    float pv[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) pv[i] = 0.f;
    if constexpr (L::kF32) {
      // A fragment of k-step kk: (g, key 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
      uint32_t ph[32], pl[32];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        sm90::split_tf32(s[4 * kk + 0], ph[4 * kk + 0], pl[4 * kk + 0]);
        sm90::split_tf32(s[4 * kk + 2], ph[4 * kk + 1], pl[4 * kk + 1]);
        sm90::split_tf32(s[4 * kk + 1], ph[4 * kk + 2], pl[4 * kk + 2]);
        sm90::split_tf32(s[4 * kk + 3], ph[4 * kk + 3], pl[4 * kk + 3]);
      }
      const uint64_t dv = sm90::make_desc(vs, L::kVtSbo);
      constexpr int kLo = L::kVtTile / 16;
      sm90::fence_regs<32>(ph);
      sm90::fence_regs<32>(pl);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if constexpr (D == 64) {
          sm90::wgmma_rs_tf32_n64(pv, pl + 4 * kk, dv + 16 * kk, kk > 0);
          sm90::wgmma_rs_tf32_n64(pv, ph + 4 * kk, dv + kLo + 16 * kk, 1);
        } else {
          sm90::wgmma_rs_tf32_n48(pv, pl + 4 * kk, dv + 16 * kk, kk > 0);
          sm90::wgmma_rs_tf32_n48(pv, ph + 4 * kk, dv + kLo + 16 * kk, 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if constexpr (D == 64)
          sm90::wgmma_rs_tf32_n64(pv, ph + 4 * kk, dv + 16 * kk, 1);
        else
          sm90::wgmma_rs_tf32_n48(pv, ph + 4 * kk, dv + 16 * kk, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<32>(ph);
      sm90::fence_regs<32>(pl);
    } else {
      // A fragment of k-step kk: the accumulator's pairs 8kk .. 8kk + 7
      uint32_t pb[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) pb[i] = sm90::pack_bf16(s[2 * i], s[2 * i + 1]);
      const uint64_t dv = sm90::make_desc(vs, L::kVtSbo);
      sm90::fence_regs<16>(pb);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 64)
          sm90::wgmma_rs_bf16_n64(pv, pb + 4 * kk, dv + 16 * kk, kk > 0);
        else
          sm90::wgmma_rs_bf16_n48(pv, pb + 4 * kk, dv + 16 * kk, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<16>(pb);
    }
    sm90::fence_regs<kO>(pv);
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    sm90::mbar_arrive(&empty[st]);
  }

  // epilogue: rows g and g + 8 of warp `warp`, columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 16 * warp + g + 8 * h;
    if (row < t_len) {
      const float inv = 1.f / l[h];
      T* orow = o + ((size_t)bh * t_len + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        sm90::store2(orow + 8 * j, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      if constexpr (kLse) {
        if (t == 0) lse[(size_t)bh * t_len + row] = (m[h] + log2f(l[h])) * 0.6931471805599453f;
      }
    }
  }
}

// K1: the inference forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               int t_len, int s_len, float scale_log2) {
  mha_fwd_body<T, D, false>(q, k, v, o, nullptr, t_len, s_len, scale_log2);
}

// K2: the training forward, which also writes lse (BH, T) f32
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mha_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                   int t_len, int s_len, float scale_log2) {
  mha_fwd_body<T, D, true>(q, k, v, o, lse, t_len, s_len, scale_log2);
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* o, float* lse, int bh,
                     int t_len, int s_len, float scale_log2, cudaStream_t s) {
  constexpr int bytes = Smem<T, D>::kBytes;
  const dim3 grid((t_len + kBlockRows - 1) / kBlockRows, bh);
  cudaError_t err;
  if (lse == nullptr) {
    err = cudaFuncSetAttribute(mha_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    mha_fwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(q, k, v, o, t_len, s_len, scale_log2);
  } else {
    err = cudaFuncSetAttribute(mha_fwd_lse_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    mha_fwd_lse_kernel<T, D><<<grid, kThreads, bytes, s>>>(q, k, v, o, lse, t_len, s_len,
                                                           scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
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
      return (int)launch_d<T, 48>(qp, kp, vp, op, lse, bh, t_len, s_len, scale_log2, s);
    case 64:
      return (int)launch_d<T, 64>(qp, kp, vp, op, lse, bh, t_len, s_len, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_mha_f32(const void* q, const void* k, const void* v, void* o,
                             int bh, int t_len, int s_len, int d, void* stream) {
  return launch<float>(q, k, v, o, nullptr, bh, t_len, s_len, d, stream);
}

extern "C" int flash_mha_bf16(const void* q, const void* k, const void* v, void* o,
                              int bh, int t_len, int s_len, int d, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, nullptr, bh, t_len, s_len, d, stream);
}

// K2's entry points: as above, plus lse (BH, T) f32, which must not be null
extern "C" int flash_mha_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int t_len, int s_len, int d,
                                 void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, o, static_cast<float*>(lse), bh, t_len, s_len, d, stream);
}

extern "C" int flash_mha_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int t_len, int s_len, int d,
                                  void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), bh, t_len, s_len, d,
                               stream);
}

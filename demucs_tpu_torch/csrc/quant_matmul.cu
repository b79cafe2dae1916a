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
// f32 is exact), the sum is f32 and the scale is applied once, after the
// sum. The TPU kernel feeds its matrix unit bf16; the port's int8 path
// runs f32 activations, as the JAX package's --int8 path does at f32, so
// x stays f32 here.
//
// A second mode (mode = 1, every form) is the --bf16 --int8 path's. There
// the JAX package widens each weight in bf16, w = bf16(bf16(q) *
// bf16(scale)), before an f32 product, so this mode forms that w where q
// is widened (int8 times a bf16 scale is exact in f32, then rounded to
// nearest even) and applies no scale after the sum:
//   y[m, n] = sum_k x[m, k] * w[n, k] + bias[n].
// Every bf16 value is exact in TF32, so the wgmma form's 2xTF32 product
// is as accurate in this mode as in the first.
//
// What bounds it on an H100: at the Demucs shapes (K, N in {512, 2048},
// M = B x {2688, 1344}) the product does 2MNK flops on a few MB of
// operands, hundreds of flops per byte, so operations. Two forms, chosen
// on the host by shape (ops/cuda/quant_matmul.py:quant_plan):
//
// "wgmma" (every shape whose rows 16-byte copies can address: K a
// multiple of 16, x and q 16-byte aligned; every path shape of both
// families) runs the product on the tensor cores as 2xTF32. An int8 value
// is exact in TF32 (8 bits of the 11), so only x is split: hi = tf32(x),
// rounded as cvt.rna.tf32.f32 rounds, and lo = tf32(x - hi); the sum is
// lo.q + hi.q, two TF32 products per f32 one (K1-K3 need three), with a
// residual below 2^-22 of |x|. The bound is 2 x 2MNK flops at 495
// TFLOP/s, 3.7x under the CUDA cores' 67 TFLOP/s f32 bound.
//   * one block = a producer warpgroup and 1 or 2 consumer warpgroups of
//     64 rows each (a 64 x 128 or 128 x 128 tile of y; the host picks by
//     waves), walking K in stages of 32 through a 6-slot mbarrier ring;
//   * the producer copies each stage's x tile (f32) and q tile (int8) into
//     a ring slot with cp.async, 4 stages ahead (80 KB in flight an SM),
//     and once a stage has landed widens q to f32 (exactly: a byte permute
//     and one subtraction) into the B tile, K-major in the canonical
//     layout of sm90.cuh. Loads through registers, two stages ahead, left
//     the producer waiting on memory latency;
//   * each consumer reads its rows of the raw x tile (4 conflict-free
//     16-byte loads a thread a stage), splits them into hi and lo in
//     registers and issues wgmma m64n128k8 tf32 with A from registers:
//     per half stage lo.q over two k-steps, then hi.q. x's split tiles
//     never touch shared memory, whose traffic (the B reads, the copies,
//     the widening) was what held the kernel when the producer wrote hi
//     and lo tiles for both operands to come from shared memory. The k of
//     a stage are permuted (kq_chunk) so that a thread's A registers for
//     all four k-steps are 8 consecutive k of each of its rows;
//   * each stage is summed in a fresh accumulator (scale_d = 0 on the
//     first product), which is then added into the running f32 sum with
//     rounded adds: the tensor core truncates as it accumulates (as
//     flash_mha.cu found), and one accumulator over K = 2048 (512 k-steps)
//     drifts 10x or more further than 32-deep chunks
//     (tests/test_torch_quant_numerics.py);
//   * the epilogue multiplies by scale[n] and adds bias[n]; ragged M and N
//     are masked (rows and columns past the end load as zeros and are not
//     stored), ragged K (a multiple of 16, not of 32) loads as zeros.
// No atomics: the same call gives the same bits.
//
// "simt" (the rest: K % 16 != 0, unaligned x or q) is a classic
// register-blocked SGEMM on the CUDA cores:
//   * one block of 256 threads per 128 x 64 tile of y (grid (ceil(N/64),
//     ceil(M/128))); each thread owns an 8 x 4 block of y in registers;
//   * the K axis goes in tiles of 16: each thread loads its part of the
//     next x tile (f32) and q tile (int8, 4 bytes at a time, widened to
//     f32) into registers while the current tiles are multiplied, then
//     stores them transposed into the other of two shared-memory buffers,
//     so one __syncthreads() per tile orders the writes before the reads;
//   * per k a thread reads 8 x values and 4 widened weights as three
//     16-byte shared loads and does 32 FMAs, the sum over k in order;
//   * ragged M, N and K are masked: out-of-range operands load as zero and
//     out-of-range outputs are not stored. Where K % 4 == 0 and the
//     pointers are aligned (the `vec` path) x and q are read 16 and 4
//     bytes at a time, else one element at a time;
//   * the epilogue multiplies by scale[n] and adds bias[n].
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the launch set-up).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "sm90.cuh"

namespace {

// scale[n] rounded to bf16 (nearest even), as an f32: the mode-1 factor
__device__ __forceinline__ float bf16_scale(const float* scale, int n) {
  return __bfloat162float(__float2bfloat16_rn(scale[n]));
}

// a widened weight value v (an int8, exact in f32) in mode kBf16W: v itself,
// or bf16(v * s) for the row's bf16 scale s
template <bool kBf16W>
__device__ __forceinline__ float weight(float v, float s) {
  return kBf16W ? __bfloat162float(__float2bfloat16_rn(v * s)) : v;
}

// ---- the "simt" form --------------------------------------------------------

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
template <bool kVec, bool kBf16W>
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          const int8_t* __restrict__ q,
                                          const float* __restrict__ scale, int M, int N,
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
    const float s = kBf16W && n < N ? bf16_scale(scale, n) : 0.f;
    wr[0] = weight<kBf16W>((float)c.x, s);
    wr[1] = weight<kBf16W>((float)c.y, s);
    wr[2] = weight<kBf16W>((float)c.z, s);
    wr[3] = weight<kBf16W>((float)c.w, s);
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
      wr[i] = (n < N && k < K)
                  ? weight<kBf16W>((float)q[(size_t)n * K + k],
                                   kBf16W ? bf16_scale(scale, n) : 0.f)
                  : 0.f;
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

template <bool kVec, bool kBf16W>
__global__ void __launch_bounds__(kThreads)
int8_matmul_simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
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
  load_tile<kVec, kBf16W>(x, q, scale, M, N, K, m0, n0, 0, tid, xr, wr);
  store_tile<kVec>(s, 0, tid, xr, wr);
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < tiles;
    if (more) load_tile<kVec, kBf16W>(x, q, scale, M, N, K, m0, n0, (t + 1) * BK, tid, xr, wr);
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
    sc[j] = n + j < N ? (kBf16W ? 1.f : scale[n + j]) : 0.f;
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

// ---- the "wgmma" form -------------------------------------------------------

constexpr int kTcK = 32;                  // K per stage, and per fresh accumulator
constexpr int kTcN = 128;                 // columns of y per block
constexpr int kTcSlots = 6;               // the ring of stages in shared memory
constexpr int kTcAhead = 4;               // stages whose copies are in flight
constexpr int kTcSbo = (kTcK / 4) * 128;  // bytes per 8 rows of a K-major f32 tile

// One instantiation's shared-memory layout: NC consumer warpgroups of 64
// rows. Per ring slot: the raw x tile (f32, 128 bytes a row, its 16-byte
// chunks XOR-swizzled by row), the widened q tile (the B operand: K-major
// in the canonical layout of sm90.cuh, its k permuted as kq_chunk says),
// and the raw q tile (int8, 32 bytes a row).
template <int NC>
struct TcLayout {
  static constexpr int kRows = 64 * NC;                 // rows of y per block
  static constexpr int kThreads = 128 * (NC + 1);       // the producer warpgroup last
  static constexpr int kX = kRows * kTcK * 4;           // bytes of the raw x tile
  static constexpr int kB = kTcN * kTcK * 4;            // bytes of the widened q tile
  static constexpr int kSlot = kX + kB + kTcN * kTcK;   // ... and of the raw q tile after it
  static constexpr int kBars = kTcSlots * kSlot;
  static constexpr int kBytes = kBars + 2 * kTcSlots * 8;
  static constexpr int kXLoads = kRows * (kTcK / 4) / 128;  // 16-byte x chunks per producer thread
  static_assert(kTcN == 128, "one q row per producer thread");
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

// the byte offset of 16-byte chunk c (k 4c .. 4c + 3) of row `row` in a raw
// x tile: XOR-swizzled so that the 8 lanes of a phase of a 16-byte access
// (8 rows, one chunk; or 2 rows, 4 chunks) hit 8 distinct bank groups
__device__ __forceinline__ int raw_x_offset(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// ... and of chunk c (k 16c .. 16c + 15) of a raw q tile's row
__device__ __forceinline__ int raw_q_offset(int row, int c) {
  return row * 32 + ((c ^ ((row >> 2) & 1)) << 4);
}

// The k order of a stage. The tf32 A fragment of k-step kk holds columns t
// and t + 4 of a row (t = lane % 4); the kernel feeds them the stage's k =
// 8t + 2kk and 8t + 2kk + 1, so that a thread's A values for all 4 k-steps
// are 8 consecutive k of each of its rows (two 16-byte loads). B follows:
// its chunk j (stage columns 4j .. 4j + 3, k-step j / 2) holds k = j + 8t
// for t = 0..3. From a q row's 32 bytes (words w[0..7], the lowest k
// first) chunk j takes byte j % 4 of words j / 4, j / 4 + 2, + 4 and + 6.
__device__ __forceinline__ uint32_t kq_chunk(const uint32_t (&w)[8], int j) {
  const uint32_t sel = (j & 3) | (((j & 3) + 4) << 4);
  const uint32_t lo = __byte_perm(w[j >> 2], w[(j >> 2) + 2], sel);
  const uint32_t hi = __byte_perm(w[(j >> 2) + 4], w[(j >> 2) + 6], sel);
  return __byte_perm(lo, hi, 0x5410);
}

// four int8 values (one 32-bit word, the first in the low byte) -> their
// f32 bit patterns, exactly: byte b + 128 placed in the low mantissa of
// 2^23, less 2^23 + 128
__device__ __forceinline__ uint4 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kBase = 8388736.f;  // 2^23 + 128
  return make_uint4(__float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kBase),
                    __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kBase),
                    __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kBase),
                    __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kBase));
}

// the stage at k0 from device memory into `slot` with cp.async (zeros past
// M, N, K): x chunks with lanes walking 8 rows, then the 8 chunks of a
// row; q row `tid`
template <int NC>
__device__ __forceinline__ void tc_copy(char* slot, const float* __restrict__ x,
                                        const int8_t* __restrict__ q, int M, int N, int K,
                                        int m0, int n0, int k0, int tid) {
  using L = TcLayout<NC>;
#pragma unroll
  for (int i = 0; i < L::kXLoads; ++i) {
    const int idx = tid + 128 * i;
    const int row = (idx >> 6) * 8 + (idx & 7), c = (idx >> 3) & 7;
    const int m = m0 + row, k = k0 + 4 * c;
    const bool ok = m < M && k < K;
    sm90::cp_async16(slot + raw_x_offset(row, c), ok ? x + (size_t)m * K + k : x, ok);
  }
  const int n = n0 + tid;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const bool ok = n < N && k0 + 16 * c < K;
    sm90::cp_async16(slot + L::kX + L::kB + raw_q_offset(tid, c),
                     ok ? q + (size_t)n * K + k0 + 16 * c : q, ok);
  }
}

// q row `tid` of the slot (copied by this thread: its own cp.async wait
// orders it), widened and permuted into the B tile; in mode kBf16W each
// value becomes bf16(v * s) for the row's bf16 scale s
template <int NC, bool kBf16W>
__device__ __forceinline__ void tc_widen(char* slot, int tid, float s) {
  using L = TcLayout<NC>;
  const char* raw = slot + L::kX + L::kB;
  const uint4 a = sm90::load16(raw + raw_q_offset(tid, 0));
  const uint4 b = sm90::load16(raw + raw_q_offset(tid, 1));
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint4 v = widen4(kq_chunk(w, j));
    if (kBf16W)
      v = make_uint4(__float_as_uint(weight<true>(__uint_as_float(v.x), s)),
                     __float_as_uint(weight<true>(__uint_as_float(v.y), s)),
                     __float_as_uint(weight<true>(__uint_as_float(v.z), s)),
                     __float_as_uint(weight<true>(__uint_as_float(v.w), s)));
    sm90::store16(slot + L::kX + sm90::kmajor_offset(tid, j, kTcSbo), v);
  }
}

// the consumer's A fragments of k-steps 2h and 2h + 1 (h: which half of
// the stage) from its rows' 8 values each (v[0] row g, v[1] row g + 8),
// split into hi and lo: a[4s + i] is register i of k-step 2h + s
__device__ __forceinline__ void tc_split(const float (&v)[2][8], int h, uint32_t (&hi)[8],
                                         uint32_t (&lo)[8]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = 4 * h + 2 * s;  // the stage's k = 8t + e (column t), 8t + e + 1 (t + 4)
    sm90::split_tf32(v[0][e], hi[4 * s + 0], lo[4 * s + 0]);
    sm90::split_tf32(v[1][e], hi[4 * s + 1], lo[4 * s + 1]);
    sm90::split_tf32(v[0][e + 1], hi[4 * s + 2], lo[4 * s + 2]);
    sm90::split_tf32(v[1][e + 1], hi[4 * s + 3], lo[4 * s + 3]);
  }
}

// grid (ceil(N / 128), ceil(M / (64 NC))), 128 (NC + 1) threads
template <int NC, bool kBf16W>
__global__ void __launch_bounds__(TcLayout<NC>::kThreads, 1)
int8_matmul_wgmma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         float* __restrict__ y, int M, int N, int K) {
  using L = TcLayout<NC>;
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kTcSlots;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int m0 = blockIdx.y * L::kRows, n0 = blockIdx.x * kTcN;
  const int stages = (K + kTcK - 1) / kTcK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcSlots; ++s) {
      sm90::mbar_init(&full[s], 128);        // the producer's threads
      sm90::mbar_init(&empty[s], 128 * NC);  // every consumer thread
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: stage s is copied (cp.async, one commit group a stage, empty
    // past the end) kTcAhead stages ahead into slot s % kTcSlots, once the
    // consumers have freed it; once it has landed, q is widened and the
    // slot signalled full
    const float s_row = kBf16W && n0 + tid < N ? bf16_scale(scale, n0 + tid) : 0.f;
    for (int s = 0; s < kTcAhead; ++s) {
      if (s < stages) tc_copy<NC>(smem + s * L::kSlot, x, q, M, N, K, m0, n0, s * kTcK, tid);
      sm90::cp_async_commit();
    }
    for (int s = 0; s < stages; ++s) {
      const int ahead = s + kTcAhead;
      if (ahead < stages) {
        const int sl = ahead % kTcSlots;
        sm90::mbar_wait(&empty[sl], ((ahead / kTcSlots) & 1) ^ 1);
        tc_copy<NC>(smem + sl * L::kSlot, x, q, M, N, K, m0, n0, ahead * kTcK, tid);
      }
      sm90::cp_async_commit();
      sm90::cp_async_wait<kTcAhead>();  // stage s's group has landed
      const int sl = s % kTcSlots;
      tc_widen<NC, kBf16W>(smem + sl * L::kSlot, tid, s_row);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[sl]);
    }
    return;
  }

  // consumer wg: rows m0 + 64 wg .. + 63; this thread's rows r0 = 16 warp +
  // g and r0 + 8 of them, its k = 8t .. 8t + 7 of every stage
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = 64 * wg + 16 * warp + g;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    const int sl = s % kTcSlots;
    sm90::mbar_wait(&full[sl], (s / kTcSlots) & 1);
    const char* slot = smem + sl * L::kSlot;
    float v[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(slot + raw_x_offset(r0 + 8 * r, 2 * t + c));
        v[r][4 * c] = f.x;
        v[r][4 * c + 1] = f.y;
        v[r][4 * c + 2] = f.z;
        v[r][4 * c + 3] = f.w;
      }
    const uint64_t dq = sm90::make_desc(sm90::smem_addr(slot + L::kX), kTcSbo);
    // this stage's lo.q, then hi.q, into a fresh accumulator, in two halves
    // of two k-steps (the A registers of a half live until its products
    // complete)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hi[8], lo[8];
      tc_split(v, h, hi, lo);
      sm90::fence_regs<8>(hi);
      sm90::fence_regs<8>(lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_rs_tf32_n128(part, lo + 4 * kk, dq + 16 * (2 * h + kk), h + kk > 0);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_rs_tf32_n128(part, hi + 4 * kk, dq + 16 * (2 * h + kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<8>(hi);
      sm90::fence_regs<8>(lo);
    }
    sm90::fence_regs<64>(part);
    sm90::mbar_arrive(&empty[sl]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // epilogue: acc[4j + 2h + e] is row 16 warp + g + 8h, column 8j + 2t + e
  // of the consumer's 64 x 128 tile
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= N) break;
    const bool two = n + 1 < N;
    const float s0 = kBf16W ? 1.f : scale[n], s1 = two ? (kBf16W ? 1.f : scale[n + 1]) : 0.f;
    const float b0 = bias != nullptr ? bias[n] : 0.f;
    const float b1 = bias != nullptr && two ? bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * warp + g + 8 * h;
      if (m >= M) continue;
      float* out = y + (size_t)m * N + n;
      const float v0 = acc[4 * j + 2 * h] * s0 + b0, v1 = acc[4 * j + 2 * h + 1] * s1 + b1;
      if (two && N % 2 == 0) {
        sm90::store2(out, v0, v1);  // 8-byte aligned: m N + n is even
      } else {
        out[0] = v0;
        if (two) out[1] = v1;
      }
    }
  }
}

template <int NC, bool kBf16W>
cudaError_t launch_wgmma(const float* x, const int8_t* q, const float* scale, const float* bias,
                         float* y, int M, int N, int K, cudaStream_t st) {
  using L = TcLayout<NC>;
  static std::once_flag once;
  static cudaError_t set = cudaSuccess;
  std::call_once(once, [] {
    set = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<NC, kBf16W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  });
  if (set != cudaSuccess) return set;
  const dim3 grid((N + kTcN - 1) / kTcN, (M + L::kRows - 1) / L::kRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_matmul_wgmma_kernel<NC, kBf16W><<<grid, L::kThreads, L::kBytes, st>>>(x, q, scale, bias,
                                                                              y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The "simt" form: y = (x @ float(q)^T) * scale (+ bias): x (M, K) f32, q
// (N, K) int8, scale and bias (N,) f32 (bias may be null), y (M, N) f32,
// all contiguous. vec != 0 asks for 16-byte x and 4-byte q reads: K % 4 ==
// 0, x 16-byte and q 4-byte aligned. mode 0: the scale after the sum; mode
// 1: y = x @ w^T (+ bias) for w = bf16(q * bf16(scale)).
extern "C" int int8_matmul_f32(const void* x, const void* q, const void* scale,
                               const void* bias, void* y, int M, int N, int K, int vec,
                               int mode, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535 || (vec && K % 4) || mode < 0 ||
      mode > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (vec && mode)
    int8_matmul_simt_kernel<true, true><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N, K);
  else if (vec)
    int8_matmul_simt_kernel<true, false><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N, K);
  else if (mode)
    int8_matmul_simt_kernel<false, true><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N, K);
  else
    int8_matmul_simt_kernel<false, false><<<grid, kThreads, 0, st>>>(xf, qi, sf, bf, yf, M, N,
                                                                      K);
  return (int)cudaGetLastError();
}

// The "wgmma" form of the same function: the arguments as above, K % 16 ==
// 0, x and q 16-byte aligned; consumers (1 or 2) is the number of 64-row
// consumer warpgroups per block, the host's choice
// (ops/cuda/quant_matmul.py:quant_plan).
extern "C" int int8_matmul_wgmma_f32(const void* x, const void* q, const void* scale,
                                     const void* bias, void* y, int M, int N, int K,
                                     int consumers, int mode, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (consumers * 2 + mode) {
    case 2:
      return (int)launch_wgmma<1, false>(xf, qi, sf, bf, yf, M, N, K, st);
    case 3:
      return (int)launch_wgmma<1, true>(xf, qi, sf, bf, yf, M, N, K, st);
    case 4:
      return (int)launch_wgmma<2, false>(xf, qi, sf, bf, yf, M, N, K, st);
    case 5:
      return (int)launch_wgmma<2, true>(xf, qi, sf, bf, yf, M, N, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

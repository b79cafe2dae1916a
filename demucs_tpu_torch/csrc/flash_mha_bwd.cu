// Fused flash-attention backward on Hopper's tensor cores (sm_90a: wgmma,
// mbarriers): K3.
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
// What bounds it: five products of 2*T*S*D flops each against q, k, v, dO,
// dq, dk, dv moved once, hundreds of flops per byte at the Demucs lengths,
// so arithmetic: 10*B*H*T*S*D flops, on the tensor cores
//   * f32 as 3xTF32: each operand x split into hi = tf32(x) and lo =
//     tf32(x - hi) (sm90::split_tf32), each product lo.hi + hi.lo + hi.hi,
//     about f32 accuracy at a third of the TF32 rate. dS = P (dP - delta)
//     cancels, so dP needs that accuracy as much as the outputs do;
//   * bf16 natively (m64nNk16), with P rounded to bf16 before dV and dS
//     rounded to bf16 before dQ and dK, as the TPU kernel rounds
//     p.astype(do.dtype) and ds.astype(k.dtype).
//
// Design. The TPU kernel walks T tiles on a sequential grid axis and keeps
// full-S dK/dV blocks resident across it; Hopper's blocks run in parallel
// in no order, so one block owns one (batch*head, 64-key tile) and walks
// every T tile itself:
//   * 3 warpgroups (384 threads). Warpgroup 2 is the producer, 0 and 1 are
//     consumers: T tile i (32 query rows) goes to consumer i % 2, through
//     its own slot of shared memory (a 2-stage ring whose stage c only
//     consumer c reads; mbarriers per slot: its natural half stored, its
//     transposed half stored, the slot free again). Both
//     consumers own all 64 keys, so each keeps its own dK and dV
//     accumulators (64 keys x D, f32, in registers); at the end consumer 1
//     hands its pair to consumer 0 through shared memory, which adds them
//     (c0 + c1, a fixed order) and stores dK and dV;
//   * resident for the whole block: K and V (keys x D, the A operands of
//     S^T and dP^T) and K^T (D x keys, zero rows up to 64 when D = 48: the
//     A operand of dQ^T), loaded and split once by all threads;
//   * per tile the producer reads Q and dO once (each thread 8 rows x 4
//     columns, all its loads issued together a tile ahead) and writes each
//     twice, natural (rows x D) for S^T = K Q^T and dP^T = V dO^T, and
//     transposed (D x rows) for dV += P^T dO and dK += dS^T Q: tf32 wgmma
//     reads only K-major shared operands, and those two products reduce
//     over the rows. It also writes lse (in the log2 domain, +inf past T)
//     and delta (0 past T). The natural half is signalled first, so the
//     consumer's S^T and dP^T run while the transposed half is written;
//   * a consumer computes S^T and dP^T (wgmma m64n32, both operands in
//     shared memory), rebuilds P^T = exp2(S^T scale log2(e) - lse log2(e))
//     and dS^T on the accumulator registers, and feeds both to dV and dK
//     from registers as the A operand (m64nD). The tf32 A fragment wants
//     rows t and t+4 of each 8 where the accumulator holds 2t and 2t+1, so
//     the rows of every 8 are permuted in Q^T and dO^T instead (K1's key
//     permutation, over the query rows here); bf16 pairs need none;
//   * dQ needs dS with the keys as the reduction axis, so the consumer also
//     writes dS (rows x keys, split for f32) into its slot, over Q and dO,
//     which its S^T and dP^T have finished reading, and computes this
//     tile's dQ^T = K^T dS^T (m64n32; at D = 48 a quarter of it is the
//     zero rows of K^T);
//   * dQ sums over the key tiles that different blocks own. It is made
//     bit-reproducible by per-key-tile partials summed in a fixed order:
//     each block stores its tile's scale * dS K, with plain stores, in
//     slice blockIdx.x of an f32 workspace dq_part (n_key_tiles, BH, T, D),
//     and dq_reduce_kernel sums the slices for each element in key-tile
//     order and writes dq in the operand dtype. (An ordered turnstile
//     would rely on the blocks becoming resident in order, which CUDA does
//     not promise; a second pass over T tiles would redo two products.)
//   * the ragged edges: rows >= T load as zeros with lse = +inf (P = 0),
//     keys >= S load as zeros (V too, so 0 x garbage never arises) with P
//     forced to 0; neither is stored.
//
// Shared memory, f32 at D = 64: K, V, K^T 3 x 2 x 16 KB = 96 KB resident,
// each slot Q, dO, Q^T, dO^T 4 x 2 x 8 KB = 64 KB, so 224.5 KB in all and
// one block per SM. That is what forced 32-row T tiles, one slot per
// consumer and 64 keys per block: every f32 operand in shared memory is
// stored twice (hi, lo) and Q and dO in both orientations, so a 64-row
// tile (128 KB) beside resident K, V and K^T (96 KB) does not fit even in
// one stage, nor do 128 keys per block (two 64-key consumers) beside any
// ring. Holding K and V as register A operands instead would take 128 of
// a consumer's 168 registers for their hi and lo fragments. In bf16 the
// same layout takes 56 KB (D = 64).
//
// What bounds it now: 2.8 ms at (4,8,2688,64) f32 on an H100 80GB HBM3 at
// 700 W (chip_smoke.py), a third of the 0.897 ms 3xTF32 bound. Each
// 32-row tile moves ~344 KB through shared memory (the m64n32 products
// re-read their 2 KB A tile per k-step and pass, the producer writes 64
// KB), which at the measured time is about half the SMs' shared-memory
// bandwidth: each consumer's chain of waits leaves the rest idle. Beside
// it the dq_part workspace (0.92 GB written and read at that shape) and
// the waves: 1344 blocks make 10.2 of 132 SMs. f32 uses all 168 registers
// a thread has at 384 threads and spills ~0.2 KB. Tried and dropped: the
// producer loading row by row (a load latency per 16 bytes: far slower),
// loads two tiles ahead (no gain), dQ staged through shared memory for
// whole-line stores (slower: two more barriers a tile), and issuing dQ^T
// before dV and dK finish, or between them with one set of A fragments
// (slower: ptxas serializes the wgmmas for want of registers).
//
// Accuracy of the sums. The tensor core truncates as it accumulates (K1
// found a running O over 42 key tiles 3e-5 of scale off). Here dK and dV
// are running wgmma accumulators over a consumer's T tiles: 42 tiles of 12
// truncating k-steps at T = 2688, which a model of that rounding (round
// toward zero after every k-step; tests/test_torch_flash_bwd_numerics.py)
// keeps under 2e-5 of scale, inside K3's 1e-4 tolerance (on an H100:
// 1.7e-5); per-tile accumulators would cost the 64 registers this kernel
// does not have. dQ^T sums one tile's 64 keys in a fresh accumulator.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes): each entry point launches both kernels on the given stream and
// returns cudaGetLastError(). dq_part needs no zeroing: every element of
// it that the reduction reads is stored first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kKeys = 64;       // keys per block: one dq_part slice each
constexpr int kRows = 32;       // query rows per T tile
constexpr int kConsumers = 2;   // consumer warpgroups; tile i goes to consumer i % 2
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout of one (T, D) instantiation; every tile is K-major
// in the canonical layout of sm90.cuh, f32 tiles as a hi part and then a lo
// part
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kParts = kF32 ? 2 : 1;
  static constexpr int kE = 16 / (int)sizeof(T);      // elements per 16-byte chunk
  static constexpr int kDSbo = D / kE * 128;          // K, V, Q, dO: along D
  static constexpr int kKeySbo = kKeys / kE * 128;    // K^T, dS: along the keys
  static constexpr int kKeyTile = kKeys * D * (int)sizeof(T);   // K or V, one part
  static constexpr int kKtTile = 64 * kKeys * (int)sizeof(T);   // K^T (D rows + zeros)
  static constexpr int kRowTile = kRows * D * (int)sizeof(T);   // Q, dO, Q^T or dO^T
  static constexpr int kDsTile = kRows * kKeys * (int)sizeof(T);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kParts * kKeyTile;
  static constexpr int kKt = kV + kParts * kKeyTile;
  static constexpr int kSlots = kKt + kParts * kKtTile;
  // one slot: Q, dO (dS over them), Q^T, dO^T, lse (log2 domain), delta
  static constexpr int kQ = 0;
  static constexpr int kDo = kParts * kRowTile;
  static constexpr int kQt = 2 * kParts * kRowTile;
  static constexpr int kDot = 3 * kParts * kRowTile;
  static constexpr int kLse = 4 * kParts * kRowTile;
  static constexpr int kDelta = kLse + kRows * 4;
  static constexpr int kSlot = kDelta + kRows * 4;
  static constexpr int kBars = kSlots + kConsumers * kSlot;
  static constexpr int kBytes = kBars + 3 * kConsumers * 8;
  static_assert(kParts * kDsTile <= kQt, "dS overlays Q and dO");
  static_assert(2 * kKeys * D * 4 <= kBars, "the dK, dV hand-over");
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

// one 16-byte chunk into a tile at byte `off`: f32 split into hi (at dst)
// and lo (at dst + part), bf16 as it is
template <typename T>
__device__ __forceinline__ void put16(char* dst, int part, int off, uint4 x) {
  if constexpr (std::is_same<T, float>::value) {
    uint4 hi, lo;
    sm90::split4(x, hi, lo);
    sm90::store16(dst + off, hi);
    sm90::store16(dst + part + off, lo);
  } else {
    sm90::store16(dst + off, x);
  }
}

// rows [0, n_valid) of an (R, D) row-major tile of src (zeros past
// n_valid) into dst, K-major along D; thread `tid` of `nt`
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(char* dst, int part, const T* src, int n_valid,
                                          int tid, int nt) {
  using L = Smem<T, D>;
  constexpr int C = D / L::kE;
  for (int idx = tid; idx < R * C; idx += nt) {
    // lanes walk 8 rows, then the chunks: each 8-lane store phase fills
    // one 128-byte core matrix
    const int r8 = idx & 7, c = (idx >> 3) % C, r = (idx / (8 * C)) * 8 + r8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) x = sm90::load16(reinterpret_cast<const char*>(src + (size_t)r * D) + 16 * c);
    put16<T>(dst, part, sm90::kmajor_offset(r, c, L::kDSbo), x);
  }
}

// rows [0, n_valid) of an (R, D) row-major tile of src (zeros past
// n_valid) into dst transposed, (D, R) K-major along R; thread `tid` of `nt`
template <typename T, int D, int R>
__device__ __forceinline__ void load_t(char* dst, int part, const T* src, int n_valid,
                                       int tid, int nt) {
  using L = Smem<T, D>;
  constexpr int DQ = D / 4;                  // groups of 4 columns
  constexpr int kSbo = R / L::kE * 128;
  for (int idx = tid; idx < (R / 8) * DQ; idx += nt) {
    const int dq = idx % DQ, kg = idx / DQ;
    // lanes dq and dq + 2 write their 4 rows of the transpose in rotated
    // order, so the rows 4 dq + ((e + rot) & 3) of 8 neighbouring lanes
    // differ mod 8
    const int rot = (dq >> 1) & 3;
    if constexpr (L::kF32) {
      uint4 x[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int r = 8 * kg + m;
        x[m] = r < n_valid ? sm90::load16(src + (size_t)r * D + 4 * dq) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (e + rot) & 3, d = 4 * dq + col;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 v = make_uint4(sm90::pick(x[4 * half], col), sm90::pick(x[4 * half + 1], col),
                                     sm90::pick(x[4 * half + 2], col), sm90::pick(x[4 * half + 3], col));
          put16<T>(dst, part, sm90::kmajor_offset(d, 2 * kg + half, kSbo), v);
        }
      }
    } else {
      uint2 x[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int r = 8 * kg + m;
        x[m] = r < n_valid ? *reinterpret_cast<const uint2*>(src + (size_t)r * D + 4 * dq)
                           : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (e + rot) & 3, d = 4 * dq + col;
        uint32_t h[8];  // element col of each of the 8 rows
#pragma unroll
        for (int m = 0; m < 8; ++m)
          h[m] = ((col < 2 ? x[m].x : x[m].y) >> (16 * (col & 1))) & 0xFFFFu;
        sm90::store16(dst + sm90::kmajor_offset(d, kg, kSbo),
                make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                           h[6] | (h[7] << 16)));
      }
    }
  }
}

// K^T's rows D .. 63 (D = 48: the zero rows of dQ^T's 64-row A operand)
template <typename T, int D>
__device__ __forceinline__ void zero_kt_pad(char* dst, int tid, int nt) {
  using L = Smem<T, D>;
  constexpr int C = kKeys / L::kE, n = (64 - D) * C;
  for (int idx = tid; idx < L::kParts * n; idx += nt) {
    const int r = D + (idx % n) / C, c = idx % C;
    sm90::store16(dst + (idx / n) * L::kKtTile + sm90::kmajor_offset(r, c, L::kKeySbo),
            make_uint4(0u, 0u, 0u, 0u));
  }
}

// one producer thread's share of a T tile: 8 rows x 4 columns of Q
// (threads 0 .. D - 1) or of dO (threads D .. 2D - 1), item (kg, dq) = rows
// 8 kg .. 8 kg + 7, columns 4 dq .. 4 dq + 3; and one row's lse (threads
// 0 .. 31) or delta (32 .. 63). All of a share's loads are issued together,
// a tile ahead of its stores, so the producer waits for one latency per
// tile at most, and reads Q and dO once for both layouts.
template <typename T>
struct Share {
  using Quad = typename std::conditional<std::is_same<T, float>::value, uint4, uint2>::type;
  Quad x[8];
  float stat;
};

template <typename T>
__device__ __forceinline__ typename Share<T>::Quad zero_quad() {
  if constexpr (std::is_same<T, float>::value)
    return make_uint4(0u, 0u, 0u, 0u);
  else
    return make_uint2(0u, 0u);
}

template <typename T, int D>
__device__ __forceinline__ void load_share(Share<T>& sh, const T* q, const T* dout,
                                           const float* lse, const float* delta, int t0,
                                           int nr, int tid) {
  constexpr int DQ = D / 4;
  if (tid < 2 * D) {
    const T* src = (tid < D ? q : dout) + (size_t)t0 * D;
    const int item = tid % D, kg = item / DQ, dq = item % DQ;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = 8 * kg + m;
      sh.x[m] = r < nr ? *reinterpret_cast<const typename Share<T>::Quad*>(
                             src + (size_t)r * D + 4 * dq)
                       : zero_quad<T>();
    }
  }
  const int r = tid & 31;
  sh.stat = tid < 32 ? (r < nr ? lse[t0 + r] * kLog2e : INFINITY)
                     : (tid < 64 && r < nr ? delta[t0 + r] : 0.f);
}

template <typename T>
__device__ __forceinline__ typename Share<T>::Quad pick8(const Share<T>& sh, int i) {
  typename Share<T>::Quad v = sh.x[0];
#pragma unroll
  for (int m = 1; m < 8; ++m)
    if (i == m) v = sh.x[m];
  return v;
}

// a share into its slot, in two halves: store_natural writes Q and dO (rows
// x D, K-major along D) and lse and delta, store_transposed writes Q^T and
// dO^T (D x rows, K-major along the rows); f32 split into hi and lo (lo
// L::kRowTile further on). f32's transpose has the rows of every 8
// permuted, chunk 0 rows 0, 2, 4, 6 and chunk 1 rows 1, 3, 5, 7, so that an
// accumulator's columns 2t, 2t + 1 are the tf32 A fragment's t, t + 4
template <typename T, int D>
__device__ __forceinline__ void store_natural(const Share<T>& sh, char* slot, int tid) {
  using L = Smem<T, D>;
  constexpr int DQ = D / 4;
  if (tid < 2 * D) {
    const int item = tid % D, kg = item / DQ, dq = item % DQ;
    char* nat = slot + (tid < D ? L::kQ : L::kDo);
    // lanes start at rotated rows so that the 8 lanes of a store phase hit
    // distinct 16-byte bank groups
    const int rot = (dq * 4 / L::kE) & 7;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int mm = (m + rot) & 7, r = 8 * kg + mm;
      if constexpr (L::kF32) {
        put16<T>(nat, L::kRowTile, sm90::kmajor_offset(r, dq, L::kDSbo), pick8<T>(sh, mm));
      } else {
        *reinterpret_cast<uint2*>(nat + sm90::kmajor_offset(r, dq >> 1, L::kDSbo) +
                                  8 * (dq & 1)) = pick8<T>(sh, mm);
      }
    }
  }
  if (tid < 64)
    reinterpret_cast<float*>(slot + (tid < 32 ? L::kLse : L::kDelta))[tid & 31] = sh.stat;
}

template <typename T, int D>
__device__ __forceinline__ void store_transposed(const Share<T>& sh, char* slot, int tid) {
  using L = Smem<T, D>;
  constexpr int DQ = D / 4;
  constexpr int kTSbo = kRows / L::kE * 128;
  if (tid >= 2 * D) return;
  const int item = tid % D, kg = item / DQ, dq = item % DQ;
  char* tr = slot + (tid < D ? L::kQt : L::kDot);
  // lanes dq and dq + 2 write their 4 rows in rotated order, so the rows
  // 4 dq + ((e + trot) & 3) of 8 neighbouring lanes differ mod 8
  const int trot = (dq >> 1) & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = (e + trot) & 3, d = 4 * dq + col;
    if constexpr (L::kF32) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 v = make_uint4(sm90::pick(sh.x[half], col), sm90::pick(sh.x[half + 2], col),
                                   sm90::pick(sh.x[half + 4], col), sm90::pick(sh.x[half + 6], col));
        put16<T>(tr, L::kRowTile, sm90::kmajor_offset(d, 2 * kg + half, kTSbo), v);
      }
    } else {
      uint32_t h[8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        h[m] = ((col < 2 ? sh.x[m].x : sh.x[m].y) >> (16 * (col & 1))) & 0xFFFFu;
      sm90::store16(tr + sm90::kmajor_offset(d, kg, kTSbo),
              make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                         h[6] | (h[7] << 16)));
    }
  }
}

// d (64 x 32, f32) = A (64 x kDepth) . B (32 x kDepth)^T, both K-major in
// shared memory; f32 as 3xTF32 with each lo part a_lo / b_lo bytes after
// its hi part (lo.hi and hi.lo first, the largest term last)
template <typename T, int kDepth>
__device__ __forceinline__ void ss_n32(float* d, uint64_t da, int a_lo, uint64_t db,
                                       int b_lo) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) {
      sm90::wgmma_ss_tf32_n32(d, da + a_lo / 16 + 16 * kk, db + 16 * kk, kk > 0);
      sm90::wgmma_ss_tf32_n32(d, da + 16 * kk, db + b_lo / 16 + 16 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk)
      sm90::wgmma_ss_tf32_n32(d, da + 16 * kk, db + 16 * kk, 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      sm90::wgmma_ss_bf16_n32(d, da + 16 * kk, db + 16 * kk, kk > 0);
  }
}

template <typename T, int D>
__device__ __forceinline__ void rs_step(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (D == 64)
      sm90::wgmma_rs_tf32_n64(d, a, db, 1);
    else
      sm90::wgmma_rs_tf32_n48(d, a, db, 1);
  } else {
    if constexpr (D == 64)
      sm90::wgmma_rs_bf16_n64(d, a, db, 1);
    else
      sm90::wgmma_rs_bf16_n48(d, a, db, 1);
  }
}

// d (64 keys x D, f32) += A (64 keys x 32 rows, registers) . B (D x 32
// rows, shared)^T: f32 A as hi (ah) and lo (al) fragments, B's lo part
// b_lo bytes after its hi part; bf16 A packed in ah
template <typename T, int D>
__device__ __forceinline__ void rs_rows(float* d, const uint32_t* ah, const uint32_t* al,
                                        uint64_t db, int b_lo) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      rs_step<T, D>(d, al + 4 * kk, db + 16 * kk);
      rs_step<T, D>(d, ah + 4 * kk, db + b_lo / 16 + 16 * kk);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) rs_step<T, D>(d, ah + 4 * kk, db + 16 * kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) rs_step<T, D>(d, ah + 4 * kk, db + 16 * kk);
  }
}

// the A fragments of a (64 x 32) accumulator x[16] (x[4j + 2h + e] is row
// g + 8h, column 8j + 2t + e): tf32 hi and lo with the columns of every 8
// permuted (see load_t), or bf16 pairs
template <typename T>
__device__ __forceinline__ void a_frags(const float* x, uint32_t* hi, uint32_t* lo) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::split_tf32(x[4 * kk + 0], hi[4 * kk + 0], lo[4 * kk + 0]);
      sm90::split_tf32(x[4 * kk + 2], hi[4 * kk + 1], lo[4 * kk + 1]);
      sm90::split_tf32(x[4 * kk + 1], hi[4 * kk + 2], lo[4 * kk + 2]);
      sm90::split_tf32(x[4 * kk + 3], hi[4 * kk + 3], lo[4 * kk + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) hi[i] = sm90::pack_bf16(x[2 * i], x[2 * i + 1]);
  }
}

// keep the A fragments in place across the wgmma that reads them
template <typename T>
__device__ __forceinline__ void fence_frags(uint32_t* ah, uint32_t* al) {
  if constexpr (std::is_same<T, float>::value) {
    sm90::fence_regs<16>(ah);
    sm90::fence_regs<16>(al);
  } else {
    sm90::fence_regs<8>(ah);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq_part, T* __restrict__ dk, T* __restrict__ dv,
               int t_len, int s_len, float scale) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) char smem[];
  // per slot: its natural half (Q, dO, lse, delta) stored, its transposed
  // half (Q^T, dO^T) stored, and the slot free again
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_t = full + kConsumers;
  uint64_t* empty = full_t + kConsumers;
  const int bh = blockIdx.y, key0 = blockIdx.x * kKeys;
  const int nk = min(kKeys, s_len - key0);
  const int n_tiles = (t_len + kRows - 1) / kRows;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  // resident for the block: K, V (keys x D) and K^T (D x keys), by all threads
  const T* kb = k + ((size_t)bh * s_len + key0) * D;
  load_rows<T, D, kKeys>(smem + L::kK, L::kKeyTile, kb, nk, threadIdx.x, kThreads);
  load_rows<T, D, kKeys>(smem + L::kV, L::kKeyTile, v + ((size_t)bh * s_len + key0) * D, nk,
                         threadIdx.x, kThreads);
  load_t<T, D, kKeys>(smem + L::kKt, L::kKtTile, kb, nk, threadIdx.x, kThreads);
  if constexpr (D < 64) zero_kt_pad<T, D>(smem + L::kKt, threadIdx.x, kThreads);
  if (threadIdx.x == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      sm90::mbar_init(&full[c], 128);   // the producer's threads
      sm90::mbar_init(&full_t[c], 128);
      sm90::mbar_init(&empty[c], 128);  // consumer c's threads
    }
    sm90::mbar_init_fence();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  if (wg == kConsumers) {
    // producer: tile i of Q, dO (natural and transposed), lse and delta
    // into slot i % 2
    const size_t rows = (size_t)bh * t_len;
    const T* qb = q + rows * D;
    const T* dob = dout + rows * D;
    Share<T> sh;
    load_share<T, D>(sh, qb, dob, lse + rows, delta + rows, 0, t_len, tid);
    for (int i = 0; i < n_tiles; ++i) {
      const int c = i % kConsumers, use = i / kConsumers;
      sm90::mbar_wait(&empty[c], (use & 1) ^ 1);
      // the natural half first: the consumer starts S^T and dP^T on it
      // while the transposed half is written
      store_natural<T, D>(sh, smem + L::kSlots + c * L::kSlot, tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[c]);
      store_transposed<T, D>(sh, smem + L::kSlots + c * L::kSlot, tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full_t[c]);
      const int t0 = (i + 1) * kRows;
      if (i + 1 < n_tiles) load_share<T, D>(sh, qb, dob, lse + rows, delta + rows, t0,
                                            t_len - t0, tid);
    }
    return;
  }

  // consumer c: tiles c, c + 2, ...; this thread's rows of the 64-key
  // accumulators are keys 16 warp + g and 16 warp + g + 8
  const int c = wg, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const float scale_log2 = scale * kLog2e;
  constexpr int kAcc = D / 2;  // registers of a (64 keys, D) accumulator
  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t base = sm90::smem_addr(smem);
  const uint64_t desc_k = sm90::make_desc(base + L::kK, L::kDSbo);
  const uint64_t desc_v = sm90::make_desc(base + L::kV, L::kDSbo);
  const uint64_t desc_kt = sm90::make_desc(base + L::kKt, L::kKeySbo);
  char* slot = smem + L::kSlots + c * L::kSlot;
  const uint32_t sb = base + L::kSlots + c * L::kSlot;
  const uint64_t desc_q = sm90::make_desc(sb + L::kQ, L::kDSbo);
  const uint64_t desc_do = sm90::make_desc(sb + L::kDo, L::kDSbo);
  const uint64_t desc_qt = sm90::make_desc(sb + L::kQt, kRows / L::kE * 128);
  const uint64_t desc_dot = sm90::make_desc(sb + L::kDot, kRows / L::kE * 128);
  const uint64_t desc_ds = sm90::make_desc(sb + L::kQ, L::kKeySbo);
  const float* lse2 = reinterpret_cast<const float*>(slot + L::kLse);
  const float* dlt = reinterpret_cast<const float*>(slot + L::kDelta);
  float* part = dq_part + ((size_t)blockIdx.x * gridDim.y + bh) * t_len * D;

  for (int i = c, use = 0; i < n_tiles; i += kConsumers, ++use) {
    sm90::mbar_wait(&full[c], use & 1);
    const int t0 = i * kRows;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 rows, f32)
    float s[16], dp[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = dp[x] = 0.f;
    sm90::wgmma_fence();
    ss_n32<T, D>(s, desc_k, L::kKeyTile, desc_q, L::kRowTile);
    ss_n32<T, D>(dp, desc_v, L::kKeyTile, desc_do, L::kRowTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<16>(s);
    sm90::fence_regs<16>(dp);

    // P^T and dS^T on the accumulators: s[4j + 2h + e] is key 16 warp + g
    // + 8h, row 8j + 2t + e of the tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
      const float2 de = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = 16 * warp + g + 8 * h < nk;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e;
          const float p = live ? exp2f(fmaf(s[x], scale_log2, -(e ? l2.y : l2.x))) : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - (e ? de.y : de.x));
        }
      }
    }
    // dS (32 rows x 64 keys, keys contiguous) over this slot's Q and dO,
    // once every warp's S^T and dP^T have finished reading them
    sm90::named_barrier(1 + c, 128);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int row = 8 * (x >> 2) + 2 * t + (x & 1), key = 16 * warp + g + 8 * ((x >> 1) & 1);
      const int off = sm90::kmajor_offset(row, key / L::kE, L::kKeySbo) +
                      (key % L::kE) * (int)sizeof(T);
      if constexpr (L::kF32) {
        uint32_t hi, lo;
        sm90::split_tf32(dp[x], hi, lo);
        *reinterpret_cast<uint32_t*>(slot + L::kQ + off) = hi;
        *reinterpret_cast<uint32_t*>(slot + L::kQ + L::kDsTile + off) = lo;
      } else {
        *reinterpret_cast<__nv_bfloat16*>(slot + L::kQ + off) = __float2bfloat16_rn(dp[x]);
      }
    }
    sm90::fence_proxy_async();

    // dV += P^T dO and dK += dS^T Q, A from registers (P^T and dS^T split
    // once more: the three products of 3xTF32 read hi and lo)
    uint32_t ph[16], pl[16], dh[16], dl[16];
    a_frags<T>(s, ph, pl);
    a_frags<T>(dp, dh, dl);
    fence_frags<T>(ph, pl);
    fence_frags<T>(dh, dl);
    sm90::mbar_wait(&full_t[c], use & 1);
    sm90::wgmma_fence();
    rs_rows<T, D>(dv_acc, ph, pl, desc_dot, L::kRowTile);
    rs_rows<T, D>(dk_acc, dh, dl, desc_qt, L::kRowTile);
    sm90::wgmma_commit();
    sm90::named_barrier(1 + c, 128);  // every thread's share of dS is written
    sm90::wgmma_wait_all();
    fence_frags<T>(ph, pl);
    fence_frags<T>(dh, dl);
    sm90::fence_regs<kAcc>(dk_acc);
    sm90::fence_regs<kAcc>(dv_acc);
    // this tile's dQ^T = K^T dS^T (64 (D and zeros) x 32 rows), fresh
    float dq[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) dq[x] = 0.f;
    sm90::wgmma_fence();
    ss_n32<T, kKeys>(dq, desc_kt, L::kKtTile, desc_ds, L::kDsTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs<16>(dq);
    sm90::mbar_arrive(&empty[c]);  // the slot is free for tile i + 2

    // into this key tile's slice of the workspace: plain stores, no atomics
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int d = 16 * warp + g + 8 * ((x >> 1) & 1);
      const int row = t0 + 8 * (x >> 2) + 2 * t + (x & 1);
      if (d < D && row < t_len) part[(size_t)row * D + d] = dq[x] * scale;
    }
  }

  // consumer 1 hands its dK, dV to consumer 0 through shared memory, which
  // every tile has finished with; consumer 0 adds them (c0 + c1) and stores
  sm90::named_barrier(3, 128 * kConsumers);
  float* xch = reinterpret_cast<float*>(smem);
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      xch[i * 128 + tid] = dk_acc[i];
      xch[(kAcc + i) * 128 + tid] = dv_acc[i];
    }
  }
  sm90::named_barrier(3, 128 * kConsumers);
  if (c == 1) return;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    dk_acc[i] += xch[i * 128 + tid];
    dv_acc[i] += xch[(kAcc + i) * 128 + tid];
  }
  // dK, dV: keys 16 warp + g + 8h, columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = 16 * warp + g + 8 * h;
    if (key < nk) {
      const size_t off = ((size_t)bh * s_len + key0 + key) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        sm90::store2(dk + off + 8 * j, dk_acc[4 * j + 2 * h] * scale,
               dk_acc[4 * j + 2 * h + 1] * scale);
        sm90::store2(dv + off + 8 * j, dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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
  constexpr int bytes = Smem<T, D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

// the dynamic shared memory one block of the kernel takes (bf16 != 0 for
// the bf16 instantiation), for reports; 0 for an unsupported d
extern "C" int flash_mha_bwd_smem_bytes(int bf16, int d) {
  if (d == 48) return bf16 ? Smem<__nv_bfloat16, 48>::kBytes : Smem<float, 48>::kBytes;
  if (d == 64) return bf16 ? Smem<__nv_bfloat16, 64>::kBytes : Smem<float, 64>::kBytes;
  return 0;
}

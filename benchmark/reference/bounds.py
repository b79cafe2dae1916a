"""The least time of a kernel call, from its input shapes: the table of
peaks and the operation and byte counts of each hand-written kernel.

The counts are frozen copies of `chip_smoke.py`'s `attention_bound`,
`dconv_bound_ms`, `lstm_bound_ms`, `tail_bound_ms` and `int8_bound`,
rewritten under one peak rule: the least time of a call is
max(operations / PEAK_FLOPS, bytes / PEAK_BYTES), where the operations
are the f32 operations the algorithm needs (not the three TF32 products
a 3xTF32 kernel issues for each) and the bytes are each input read once
and each output written once. PEAK_FLOPS is the H100 SXM's dense TF32
rate: no route that keeps f32 accuracy runs faster, so a share of this
bound cannot pass 100%. The count is the same whatever implements the
call.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = 495e12   # TF32 tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

F32 = 4  # bytes per element: every benchmarked path runs in f32


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """-> (least time in seconds, "operations" or "bytes": which bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_mha(q, k, v) -> tuple[float, float]:
    """K1. q (B, H, T, D), k and v (B, H, S, D): 4·BHTSD operations (two
    products); q, k, v read and o written once."""
    B, H, T, D = q
    S = k[2]
    return 4.0 * B * H * T * S * D, F32 * 2.0 * B * H * (T + S) * D


def flash_mha_fwd(q, k, v) -> tuple[float, float]:
    """K2. As K1, plus lse (B, H, T) f32 written."""
    flops, nbytes = flash_mha(q, k, v)
    B, H, T, _ = q
    return flops, nbytes + 4.0 * B * H * T


def flash_mha_bwd(q, k, v, o, lse, do) -> tuple[float, float]:
    """K3. 10·BHTSD operations (five products: S, dP, dV, dQ, dK); q, k,
    v, o, lse, dO read and dq, dk, dv written once."""
    B, H, T, D = q
    S = k[2]
    return 10.0 * B * H * T * S * D, F32 * B * H * D * (4 * T + 4 * S) + 4.0 * B * H * T


def dconv_sub_block(x, w0, *rest) -> tuple[float, float]:
    """K5. x (N, C, T), w0 (h, C, 3): the two convolutions' 10·NTCh
    operations (3 taps and 1x1, two per multiply-add) plus about 15 per
    element of the hidden and the output rows (two GroupNorms, GELU,
    GLU, LayerScale, residual); x read and out written once, the weights
    once."""
    N, C, T = x
    h = w0[0]
    return (N * T * (10.0 * C * h + 15.0 * (h + C)),
            F32 * (2 * N * C * T + 5 * C * h + 3 * h + 5 * C))


def gn_glu_scale_res(x, weight, bias, scale, res) -> tuple[float, float]:
    """K4. x (R, 2C, T), res (R, C, T): about 15 operations per output
    element; x and res read and out written once."""
    R, C, T = res
    return 15.0 * R * C * T, F32 * (4 * R * C * T + 5 * C)


def bilstm_recurrence(xs, w_hh) -> tuple[float, float]:
    """K6. xs (T, 2, B, 4H), w_hh (2, H, 4H): both directions' h @ w_hh,
    16·T·B·H² operations; xs and w_hh read and ys (T, 2, B, H) written
    once."""
    T, _, B, H4 = xs
    H = H4 // 4
    return 16.0 * T * B * H * H, F32 * (T * 2 * B * 4 * H + 2 * H * 4 * H + T * 2 * B * H)


def int8_matmul(x, q, *rest) -> tuple[float, float]:
    """K7. x (M, K) f32, q (N, K) int8: 2MNK operations; x, q, scale and
    bias read and y (M, N) f32 written once."""
    M, K = math.prod(x[:-1]), x[-1]
    N = q[0]
    return 2.0 * M * N * K, F32 * M * K + N * K + 8.0 * N + F32 * M * N


# the program's custom op (torch.ops.demucs_tpu_torch.<name>) -> its count
# and the fragments of the names of the CUDA kernels it launches
KERNELS = {
    "flash_mha": (flash_mha, ("mha_fwd_kernel",)),
    "flash_mha_fwd": (flash_mha_fwd, ("mha_fwd_lse_kernel",)),
    "flash_mha_bwd": (flash_mha_bwd, ("mha_bwd_kernel", "dq_reduce_kernel")),
    "dconv_sub_block": (dconv_sub_block, ("dconv_row_kernel", "dconv_tile_")),
    "gn_glu_scale_res": (gn_glu_scale_res, ("gn_glu_",)),
    "bilstm_recurrence": (bilstm_recurrence, ("bilstm_cluster_kernel", "bilstm_kernel")),
    "int8_matmul": (int8_matmul, ("int8_matmul_",)),
}

"""The int8-dequant matmul: the CUDA kernel's wrapper (K7) and its plain twin.

`int8_matmul` (K7, `csrc/quant_matmul.cu`) replaces the Pallas TPU
kernel `demucs_tpu/ops/pallas/quant_matmul.py:int8_matmul` (`_kernel`):
y = (x @ float(q)^T) * scale + bias for x (M, K) f32 and a weight held
as int8 q (N, K) with an f32 scale per output channel, in nn.Linear
layout. The weight is widened inside the kernel, the sum is f32 and the
scale comes after it. On the `--int8` path it runs every nn.Linear-layout
product of a quantized weight, through `ops.attention.linear`: the Q, K,
V and output projections and both feed-forward linears of every
htdemucs transformer layer (60 per segment batch for htdemucs-4s), and
the BiLSTM output linear of hdemucs_mmi's encoder-4/5 sub-blocks (4).

What bounds it on an H100: at the Demucs shapes the operations, on the
CUDA cores in f32 (no tensor cores in this first form); the source says
more, `PERF.md` has the times.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain twin for CPU tensors; it never falls back. It takes f32 x, scale
and bias and int8 q, and it raises on CUDA inputs that require grad
under grad mode: the kernel writes through raw pointers, which would
drop the gradient, and quantized weights are for inference. `launches`
counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = "quant_matmul"
SOURCES = (SOURCE,)
TILE_M = 128  # rows of y per block (csrc/quant_matmul.cu BM)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """(x @ float(q)^T) * scale (+ bias): x (M, K), q (N, K), scale and bias
    (N,) -> (M, N) f32, the kernel's order of operations."""
    y = (x.float() @ q.float().T) * scale.float()
    return y if bias is None else y + bias.float()


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """K7. x (M, K) f32, q (N, K) int8, scale (N,) f32, bias (N,) f32 or
    None -> y (M, N) f32, a new tensor."""
    ts = (x, q, scale) if bias is None else (x, q, scale, bias)
    if build.on_cpu("int8_matmul", *ts):
        return int8_matmul_plain(x, q, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "int8_matmul writes its CUDA result through raw pointers, which would "
            "drop the gradient, and quantized weights are for inference; call it "
            "under torch.no_grad()")
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"int8_matmul: want x (M, K) and q (N, K), got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[0]
    for name, t, dtype, shape in (("x", x, torch.float32, (M, K)),
                                  ("q", q, torch.int8, (N, K)),
                                  ("scale", scale, torch.float32, (N,)),
                                  ("bias", bias, torch.float32, (N,))):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"int8_matmul takes {name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"int8_matmul: want {name} {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if not (1 <= M <= 65535 * TILE_M and 1 <= N < 2 ** 31 and 1 <= K < 2 ** 31):
        raise ValueError(f"int8_matmul: M={M}, N={N}, K={K} out of range")
    vec = K % 4 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    fn = build.entry_point(SOURCE, "int8_matmul_f32", 5, 4)
    build.launch("int8_matmul", fn, x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 0 if bias is None else bias.data_ptr(), y.data_ptr(), M, N, K, int(vec))
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0

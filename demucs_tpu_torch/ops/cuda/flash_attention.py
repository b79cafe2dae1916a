"""Flash multi-head attention: the CUDA kernel's wrapper and its plain twin.

Replaces the Pallas TPU kernel `demucs_tpu/ops/pallas/attention.py:
flash_mha` (`_mha_kernel`), the only kernel on the htdemucs inference
path: the crosstransformer makes 10 such calls per segment batch.

The kernel (`csrc/flash_mha.cu`) computes what `_mha_kernel` computes:
non-causal attention of q (B, H, T, D) over k, v (B, H, S, D) with the
softmax at 1/sqrt(D) and an f32 running max, sum and accumulator, so the
(B, H, T, S) logits never reach device memory. It takes f32 or bf16
operands, D in {48, 64} and any T and S: it masks the ragged edges
itself, so the port needs no counterpart of the JAX package's
`flash_supported` gate and no einsum fallback.

What bounds it on an H100: 4*B*H*T*S*D flops against four (B, H, *, D)
tensors moved, hundreds of flops per byte at the Demucs lengths, so it
is bound by arithmetic. This form keeps the arithmetic on the CUDA
cores (f32 FMAs, also for bf16 operands, which it widens on load) and
register-blocks both products as an f32 GEMM does: a block of 256
threads owns 64 query rows, streams K/V in 64-key tiles through shared
memory, and each thread computes a 4 x 4 block of logits and a 4-row
block of the output, so that every 128-bit shared-memory read feeds
several FMAs. The tensor cores (`wgmma`) and TMA loads are later work.

`flash_mha` launches the kernel for CUDA tensors (or raises) and runs
`flash_mha_plain` for CPU tensors; it never falls back. `launches`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

SOURCE = "flash_mha"
SUPPORTED_HEAD_DIMS = (48, 64)
_DTYPES = {torch.float32: "flash_mha_f32", torch.bfloat16: "flash_mha_bf16"}
_fns: dict = {}  # dtype -> bound C entry point


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention: f32 logits at 1/sqrt(D), softmax, product;
    the result in the operands' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def _kernel(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _DTYPES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_mha takes f32 or bf16 operands of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,T,D), k/v (B,H,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, heads or head dim")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if T < 1 or k.shape[2] < 1 or not 1 <= B * H <= 65535:
        raise ValueError(f"empty or oversized attention: B*H={B * H}, "
                         f"T={T}, S={k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, H, T, D), k/v: (B, H, S, D) -> (B, H, T, D)."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_mha_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    B, H, T, D = q.shape
    fn = _kernel(q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B * H, T, k.shape[2], D, stream)
    if rc:
        raise RuntimeError(f"flash_mha kernel launch failed: CUDA error {rc}")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0

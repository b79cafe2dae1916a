"""Flash multi-head attention: the CUDA kernels' wrappers and their plain twins.

Three kernels, each replacing a Pallas TPU kernel of
`demucs_tpu/ops/pallas/attention.py`:

  * `flash_mha` (K1, `csrc/flash_mha.cu`) replaces `flash_mha`
    (`_mha_kernel`), the inference forward: 10 calls per segment batch;
  * `flash_mha_fwd` (K2, same source) replaces `flash_mha_fwd`
    (`_mha_fwd_lse_kernel`), the training forward, which also returns
    the per-row logsumexp of the scaled logits;
  * `flash_mha_bwd` (K3, `csrc/flash_mha_bwd.cu`) replaces
    `flash_mha_bwd` (`_mha_bwd_fused_kernel`), the fused backward.
    K2 and K3 run 10 times each per training step, through
    `ops.attention.FlashSDPA`.

They compute non-causal attention of q (B, H, T, D) over k, v (B, H, S,
D) with the softmax at 1/sqrt(D) and f32 running statistics and
accumulators, so the (B, H, T, S) logits never reach device memory. They
take f32 or bf16 operands, D in {48, 64} and any T and S (the ragged
edges are masked in the kernels), so the port needs no counterpart of the
JAX package's `flash_supported` gate and no einsum fallback.

What bounds them on an H100: 4*B*H*T*S*D flops (K1, K2) and
10*B*H*T*S*D (K3) against a few (B, H, *, D) tensors moved, hundreds of
flops per byte at the Demucs lengths, so arithmetic. All three run their
products on the tensor cores (`wgmma`): bf16 operands natively, f32
operands as 3xTF32 (each operand split into a TF32 hi and lo part, three
TF32 products, about f32 accuracy at a third of the TF32 rate), with one
producer warpgroup filling an mbarrier ring: of K and V^T tiles for K1 and
K2, of Q and dO tiles (each in both orientations) for K3, whose two
consumer warpgroups take the 32-row T tiles of a 64-key block in turns.
The sources say more.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain twin for CPU tensors; it never falls back. Each is bound as a
custom op, `torch.ops.demucs_tpu_torch.<name>` (`build.define_op`), so
an exported program calls it. `launches` counts
the kernel launches, `launches_by_dtype` those of each dtype (the
`--bf16` path runs K1's bf16 form, `--bf16-compute` training K2's and
K3's). The kernels write through raw pointers, so their
results carry no autograd history: on CUDA tensors that require grad,
under grad mode, the wrappers raise rather than drop the gradient.
Differentiable use goes through `ops.attention.FlashSDPA`.
"""

from __future__ import annotations

import math

import torch

from . import build

SOURCE = "flash_mha"          # K1 and K2
BWD_SOURCE = "flash_mha_bwd"  # K3
SOURCES = (SOURCE, BWD_SOURCE)
SUPPORTED_HEAD_DIMS = (48, 64)
BWD_KEY_TILE = 64  # keys per K3 block (csrc/flash_mha_bwd.cu kKeys): one dq slice each


# --- plain twins --------------------------------------------------------

def flash_mha_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention: f32 logits at 1/sqrt(D), softmax, product;
    the result in the operands' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def flash_mha_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_mha_plain` plus lse (B, H, T) f32, the natural-log
    logsumexp of the scaled logits."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - lse[..., None])
    return torch.matmul(weights, v.float()).to(q.dtype), lse


def flash_mha_bwd_plain(q, k, v, o, lse, do):
    """The backward formulas of `demucs_tpu/ops/attention.py:_sdpa_bwd`
    in their flash form, written out (not autograd), all in f32:

        P = exp(scale QK^T - lse), dP = dO V^T, delta = rowsum(dO * O),
        dS = P (dP - delta), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO

    -> (dq, dk, dv) in the operands' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- kernels ------------------------------------------------------------

def _kernel(entry: str, dtype: torch.dtype, n_ptrs: int):
    source = BWD_SOURCE if entry == "flash_mha_bwd" else SOURCE
    return build.entry_point(source, f"{entry}_{build.DTYPE_SUFFIX[dtype]}", n_ptrs, 4)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *extra: tuple[str, torch.Tensor]) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *(t for _, t in extra))):
        raise RuntimeError(
            f"{name} writes its CUDA result through raw pointers, which would "
            "drop the gradient; differentiate through ops.attention.FlashSDPA "
            "(or call this under torch.no_grad())")
    if q.dtype not in build.DTYPE_SUFFIX or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name} takes f32 or bf16 operands of one dtype, "
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
    for tname, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != q.device:
            raise ValueError(f"{tname} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{tname} must be contiguous and 16-byte aligned")


def _flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check("flash_mha", q, k, v)
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    build.launch("flash_mha", _kernel("flash_mha", q.dtype, 4), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, T, k.shape[2], D)
    flash_mha.launches += 1
    flash_mha.launches_by_dtype[str(q.dtype)[6:]] += 1
    return out


def _flash_mha_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    _check("flash_mha_fwd", q, k, v)
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    build.launch("flash_mha_fwd", _kernel("flash_mha_fwd", q.dtype, 5), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B * H, T, k.shape[2], D)
    flash_mha_fwd.launches += 1
    flash_mha_fwd.launches_by_dtype[str(q.dtype)[6:]] += 1
    return out, lse


def _flash_mha_bwd_cuda(q, k, v, o, lse, do):
    _check("flash_mha_bwd", q, k, v, ("o", o), ("lse", lse), ("do", do))
    B, H, T, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, T) f32, got {tuple(lse.shape)} {lse.dtype}")
    delta = (do.float() * o.float()).sum(-1)
    S = k.shape[2]
    dq_part = torch.empty(-(-S // BWD_KEY_TILE), B, H, T, D, device=q.device,
                          dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    build.launch("flash_mha_bwd", _kernel("flash_mha_bwd", q.dtype, 10), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq_part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B * H, T, S, D)
    flash_mha_bwd.launches += 1
    flash_mha_bwd.launches_by_dtype[str(q.dtype)[6:]] += 1
    return dq, dk, dv


_flash_mha_op = build.define_op(
    "flash_mha", "(Tensor q, Tensor k, Tensor v) -> Tensor",
    _flash_mha_cuda, flash_mha_plain, lambda q, k, v: q.new_empty(q.shape))
_flash_mha_fwd_op = build.define_op(
    "flash_mha_fwd", "(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)",
    _flash_mha_fwd_cuda, flash_mha_fwd_plain,
    lambda q, k, v: (q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)))
_flash_mha_bwd_op = build.define_op(
    "flash_mha_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor dout) "
    "-> (Tensor, Tensor, Tensor)",
    _flash_mha_bwd_cuda, flash_mha_bwd_plain,
    lambda q, k, v, o, lse, do: (q.new_empty(q.shape), k.new_empty(k.shape),
                                 v.new_empty(v.shape)))


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1. q: (B, H, T, D), k/v: (B, H, S, D) -> (B, H, T, D)."""
    return build.call_op("flash attention", _flash_mha_op, q, k, v)


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2. q: (B, H, T, D), k/v: (B, H, S, D) -> (out (B, H, T, D),
    lse (B, H, T) f32)."""
    return build.call_op("flash attention", _flash_mha_fwd_op, q, k, v)


def flash_mha_bwd(q, k, v, o, lse, do):
    """K3. The forward's q, k, v, out o and lse (B, H, T) f32, and the
    output cotangent do (B, H, T, D) -> (dq, dk, dv) in the operands'
    dtype. delta = rowsum(dO * O) is one torch reduction here, before the
    launch. dq is bit-reproducible: each 64-key tile's share lands in its
    own slice of an f32 workspace, summed in tile order by the kernel's
    second pass (no atomics)."""
    return build.call_op("flash attention", _flash_mha_bwd_op, q, k, v, o, lse, do)


flash_mha.launches = 0
flash_mha.launches_by_dtype = {"float32": 0, "bfloat16": 0}
flash_mha_fwd.launches = 0
flash_mha_fwd.launches_by_dtype = {"float32": 0, "bfloat16": 0}
flash_mha_bwd.launches = 0
flash_mha_bwd.launches_by_dtype = {"float32": 0, "bfloat16": 0}

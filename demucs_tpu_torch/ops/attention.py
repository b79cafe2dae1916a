"""Multi-head attention and the Demucs transformer encoder layer.

The port of `demucs_tpu/ops/attention.py`. The layer implements both
the self-attention ("MyTransformerEncoderLayer") and cross-attention
("CrossTransformerEncoderLayer") variants of Demucs v4:

    x = x + gamma_1 * out_proj(MHA(norm1(x), norm_kv(kv)))
    x = x + gamma_2 * linear2(gelu(linear1(norm_ff(x))))
    x = GroupNorm1(x)          # 'norm_out', over (T, C) per batch item

Weight layout follows torch.nn.MultiheadAttention: packed
in_proj_weight (3C, C) with rows [Q; K; V]. A linear whose weight is an
int8 `QuantizedWeight` (`--int8`) is the kernel K7 (`int8_matmul`); an
fp8 one is widened and multiplied densely. The scaled dot product runs
through the flash kernels of `ops.cuda`: the CUDA kernels on the GPU,
their plain twins on the CPU. Without gradients it is the inference
kernel K1 (`flash_mha`); with them it is `FlashSDPA`, the counterpart of
the JAX package's `_sdpa` custom VJP: K2 (`flash_mha_fwd`) forward, K3
(`flash_mha_bwd`) backward.

With a tensor-parallel process group (`group`, `parallel/`), a layer
holds this rank's share of the projections (`parallel.sharding`): its
heads' rows of Q, K and V and of linear1, the matching columns of
out_proj and linear2. Each rank projects its own heads and runs the
kernels on (B, H/tp, T, D), the counterpart of the JAX package's
partitioning rule for `flash_mha_p`; the partial products of out_proj
and linear2 are summed over the group (`reduce_from_tp`) and their
biases added once, after the sum; LayerScale and the norms then run on
the full, replicated tokens. The two Megatron operators carry the
gradient: `copy_to_tp` (identity forward, all-reduce backward) before
the column-parallel projections, `reduce_from_tp` (all-reduce forward,
identity backward) after the row-parallel ones, so a rank's gradients
equal the single-process ones. Without a group the layer is the
single-device one, operation for operation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .cuda import flash_mha, flash_mha_bwd, flash_mha_fwd, int8_matmul
from .norms import gelu, layer_norm
from .quant import QuantizedWeight, dense


def linear(x: torch.Tensor, w: torch.Tensor | QuantizedWeight,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """PyTorch nn.Linear: x @ w.T + b with w of shape (out, in). An int8
    weight goes to K7 (its plain twin on CPU tensors) with x flattened to
    (M, in), in the weight's widening mode (`QuantizedWeight.dtype`)."""
    if isinstance(w, QuantizedWeight) and w.q.dtype == torch.int8:
        y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q, w.scale.reshape(-1), b,
                        weight_dtype=w.dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x, dense(w).to(x.dtype), None if b is None else b.to(x.dtype))


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the
    gradient over the group, whose ranks each hold the part of it that
    flows through their own heads or hidden units."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the forward sums the ranks' partial products over the
    group; the backward is the identity, every rank's gradient being the
    full one already. (`torch.distributed.nn.functional.all_reduce` sums
    the identical gradients in its backward: tp times the gradient.)"""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """`x` before a column-parallel projection; `x` itself without a group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of the ranks' partial products `x`; `x`
    itself without a group."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor | QuantizedWeight,
                        b: torch.Tensor | None, group) -> torch.Tensor:
    """`linear` of a weight split on its input columns: this rank's partial
    product, summed over the group, then the bias, added once. Without a
    group, `linear(x, w, b)`."""
    if group is None:
        return linear(x, w, b)
    y = reduce_from_tp(linear(x, w), group)
    return y if b is None else y + b.to(y.dtype)


class FlashSDPA(torch.autograd.Function):
    """Differentiable flash attention on heads-major q (B,H,T,D), k/v
    (B,H,S,D): the forward saves q, k, v, the output and its per-row
    logsumexp (K2), the backward rebuilds P from them (K3) instead of
    keeping the (B,H,T,S) attention weights. On CPU tensors the same
    Function runs the kernels' plain twins."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_mha_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_mha_bwd(q, k, v, out, lse, dout.contiguous())


def _sdpa(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(B,T,H,D),(B,S,H,D)x2 -> (B,T,H,D) through the flash kernels, which
    take heads-major (B,H,T,D): K1 when no gradient is wanted, else
    `FlashSDPA` (K2 forward, K3 backward)."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in (Q, K, V))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashSDPA.apply(q, k, v)
    else:
        out = flash_mha(q, k, v)
    return out.transpose(1, 2)


def multihead_attention(q: torch.Tensor, kv: torch.Tensor,
                        in_proj_weight: torch.Tensor | QuantizedWeight,
                        in_proj_bias: torch.Tensor,
                        out_proj_weight: torch.Tensor | QuantizedWeight,
                        out_proj_bias: torch.Tensor,
                        num_heads: int, group=None) -> torch.Tensor:
    """q: (B, T, C), kv: (B, S, C) -> (B, T, C).

    torch.nn.MultiheadAttention semantics (batch_first), packed QKV
    projection, per-head scaled dot-product, fp32 softmax. With a tensor
    parallel `group`, the weights are this rank's share (its num_heads /
    tp heads) and the output is summed over the group.
    """
    B, T, _ = q.shape
    S = kv.shape[1]
    H = num_heads if group is None else num_heads // dist.get_world_size(group)

    wq, wk, wv = in_proj_weight.chunk(3)  # rows, with their scales if quantized
    bq, bk, bv = torch.chunk(in_proj_bias, 3, dim=0)
    D = wq.shape[0] // H
    qf = copy_to_tp(q, group)
    kvf = qf if kv is q else copy_to_tp(kv, group)
    Q = linear(qf, wq, bq).reshape(B, T, H, D)
    K = linear(kvf, wk, bk).reshape(B, S, H, D)
    V = linear(kvf, wv, bv).reshape(B, S, H, D)

    out = _sdpa(Q, K, V).reshape(B, T, H * D)
    return row_parallel_linear(out, out_proj_weight, out_proj_bias, group)


def transformer_layer(x: torch.Tensor, kv: torch.Tensor | None, p,
                      num_heads: int = 8, eps: float = 1e-5, group=None) -> torch.Tensor:
    """One Demucs transformer encoder layer on (B, T, C) tokens.

    `p` is the layer's module (`models.htdemucs.CrossTransformerLayer`),
    the counterpart of the JAX parameter subtree. `kv=None` selects the
    self-attention variant (norm1/norm2, self_attn); otherwise the
    cross-attention variant (norm1/norm2/norm3, cross_attn). `group`: the
    tensor-parallel process group whose share of the projections `p`
    holds, or None.
    """
    cross = kv is not None
    attn = p.cross_attn if cross else p.self_attn
    qn = layer_norm(x, p.norm1.weight, p.norm1.bias, eps)
    kn = layer_norm(kv, p.norm2.weight, p.norm2.bias, eps) if cross else qn
    a = multihead_attention(
        qn, kn, attn.in_proj_weight, attn.in_proj_bias,
        attn.out_proj.weight, attn.out_proj.bias, num_heads, group)
    x = x + a * p.gamma_1.scale

    ff_norm = p.norm3 if cross else p.norm2
    h = layer_norm(x, ff_norm.weight, ff_norm.bias, eps)
    h = linear(copy_to_tp(h, group), p.linear1.weight, p.linear1.bias)
    h = gelu(h)
    h = row_parallel_linear(h, p.linear2.weight, p.linear2.bias, group)
    x = x + h * p.gamma_2.scale

    # norm_out: GroupNorm(1, C) applied channel-first. With one group the
    # statistics cover every (token, channel) element per batch item, so
    # the norm runs directly on (B, T, C), one pass, biased variance.
    xf = x.float()
    n = xf.shape[1] * xf.shape[2]
    mean = xf.sum((1, 2)) / n
    var = torch.clamp(xf.square().sum((1, 2)) / n - mean.square(), min=0.0)
    y = (xf - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    return (y * p.norm_out.weight.float() + p.norm_out.bias.float()).to(x.dtype)

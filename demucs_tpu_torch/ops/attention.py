"""Multi-head attention and the Demucs transformer encoder layer.

The port of `demucs_tpu/ops/attention.py`. The layer implements both
the self-attention ("MyTransformerEncoderLayer") and cross-attention
("CrossTransformerEncoderLayer") variants of Demucs v4:

    x = x + gamma_1 * out_proj(MHA(norm1(x), norm_kv(kv)))
    x = x + gamma_2 * linear2(gelu(linear1(norm_ff(x))))
    x = GroupNorm1(x)          # 'norm_out', over (T, C) per batch item

Weight layout follows torch.nn.MultiheadAttention: packed
in_proj_weight (3C, C) with rows [Q; K; V]. The scaled dot product runs
through `ops.cuda.flash_mha`: the CUDA kernel on the GPU, its plain
version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import flash_mha
from .norms import gelu, layer_norm


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    """PyTorch nn.Linear: x @ w.T + b with w of shape (out, in)."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def _sdpa(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(B,T,H,D),(B,S,H,D)x2 -> (B,T,H,D) through the flash kernel, which
    takes heads-major (B,H,T,D)."""
    out = flash_mha(Q.transpose(1, 2).contiguous(),
                    K.transpose(1, 2).contiguous(),
                    V.transpose(1, 2).contiguous())
    return out.transpose(1, 2)


def multihead_attention(q: torch.Tensor, kv: torch.Tensor,
                        in_proj_weight: torch.Tensor,
                        in_proj_bias: torch.Tensor,
                        out_proj_weight: torch.Tensor,
                        out_proj_bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """q: (B, T, C), kv: (B, S, C) -> (B, T, C).

    torch.nn.MultiheadAttention semantics (batch_first), packed QKV
    projection, per-head scaled dot-product, fp32 softmax.
    """
    B, T, C = q.shape
    S = kv.shape[1]
    H = num_heads
    D = C // H

    wq, wk, wv = torch.chunk(in_proj_weight, 3, dim=0)
    bq, bk, bv = torch.chunk(in_proj_bias, 3, dim=0)
    Q = linear(q, wq, bq).reshape(B, T, H, D)
    K = linear(kv, wk, bk).reshape(B, S, H, D)
    V = linear(kv, wv, bv).reshape(B, S, H, D)

    out = _sdpa(Q, K, V).reshape(B, T, C)
    return linear(out, out_proj_weight, out_proj_bias)


def transformer_layer(x: torch.Tensor, kv: torch.Tensor | None, p,
                      num_heads: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """One Demucs transformer encoder layer on (B, T, C) tokens.

    `p` is the layer's module (`models.htdemucs.CrossTransformerLayer`),
    the counterpart of the JAX parameter subtree. `kv=None` selects the
    self-attention variant (norm1/norm2, self_attn); otherwise the
    cross-attention variant (norm1/norm2/norm3, cross_attn).
    """
    cross = kv is not None
    attn = p.cross_attn if cross else p.self_attn
    qn = layer_norm(x, p.norm1.weight, p.norm1.bias, eps)
    kn = layer_norm(kv, p.norm2.weight, p.norm2.bias, eps) if cross else qn
    a = multihead_attention(
        qn, kn, attn.in_proj_weight, attn.in_proj_bias,
        attn.out_proj.weight, attn.out_proj.bias, num_heads)
    x = x + a * p.gamma_1.scale

    ff_norm = p.norm3 if cross else p.norm2
    h = layer_norm(x, ff_norm.weight, ff_norm.bias, eps)
    h = linear(h, p.linear1.weight, p.linear1.bias)
    h = gelu(h)
    h = linear(h, p.linear2.weight, p.linear2.bias)
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

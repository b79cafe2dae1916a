"""Norms and activations with PyTorch-compatible semantics.

The port of `demucs_tpu/ops/norms.py`. It keeps the JAX package's
statistics convention: one-pass mean and biased variance,
E[x^2] - mean^2, accumulated in float32.
"""

from __future__ import annotations

import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in float32: 0.5*x*(1+erf(x/sqrt(2)))."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))
    return y.to(x.dtype)


def glu(x: torch.Tensor, axis: int,
        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Gated linear unit along `axis`.

    `bias` is an optional pre-GLU per-channel bias (length x.shape[axis]):
    glu(x + bias) with the bias added to each half."""
    a, b = torch.chunk(x, 2, dim=axis)
    if bias is not None:
        shape = [1] * x.ndim
        shape[axis] = bias.shape[0] // 2
        b1, b2 = torch.chunk(bias.to(x.dtype), 2)
        a = a + b1.reshape(shape)
        b = b + b2.reshape(shape)
    return a * torch.sigmoid(b)


def _mean_var(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass mean and biased variance: E[x^2] - mean^2."""
    mean = xf.mean(dims, keepdim=True)
    mean2 = xf.square().mean(dims, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return mean, var


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis."""
    xf = x.float()
    mean, var = _mean_var(xf, -1)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """PyTorch nn.GroupNorm over (B, C, *spatial)."""
    B, C = x.shape[:2]
    spatial = x.shape[2:]
    xf = x.float().reshape(B, num_groups, -1)
    mean, var = _mean_var(xf, -1)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, *spatial)
    shape = (1, C) + (1,) * len(spatial)
    return (y * weight.reshape(shape) + bias.reshape(shape)).to(x.dtype)


def group_norm_fmajor(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm for F-major (B, F, C, T) tensors: statistics per channel
    group over (F, C/G, T), identical to nn.GroupNorm on the
    channel-major (B, C, F, T) view."""
    B, Fq, C, T = x.shape
    xf = x.float().reshape(B, Fq, num_groups, C // num_groups, T)
    mean, var = _mean_var(xf, (1, 3, 4))
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, Fq, C, T)
    w = weight.reshape(1, 1, C, 1)
    b = bias.reshape(1, 1, C, 1)
    return (y * w + b).to(x.dtype)


def layer_scale(x: torch.Tensor, scale: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Per-channel scalar multiply."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return x * scale.reshape(shape)

"""Demucs v3 LocalState: local attention with learned decay penalties.

The port of `demucs_tpu/ops/local_attention.py`, in plain torch:

    dots[b,h,t,s] = <key[:,t], query[:,s]> / sqrt(D)
                    + sum_n decay_q[b,h,n,s] * decay_kernel[n, |t-s|]
    dots[t==s]    = -100
    weights       = softmax over t (the key axis), in f32
    out[:, s]     = proj( sum_t weights[t,s] * content[:, t] ) + x[:, s]

with decay_q = sigmoid(query_decay(x)) / 2 and
decay_kernel[n, d] = -(n+1) * d / sqrt(ndecay).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.device import on_device
from .conv import conv1d

N_HEADS = 4
N_DECAY = 4


@functools.lru_cache(maxsize=None)
def decay_kernel(length: int, ndecay: int = N_DECAY) -> np.ndarray:
    """(ndecay, T, T) additive decay basis, built in f64 and cast to f32,
    once per length. Every caller shares the array: do not write to it."""
    idx = np.arange(length, dtype=np.float64)
    delta = np.abs(idx[:, None] - idx[None, :])  # (T, T) = |t - s|
    decays = np.arange(1, ndecay + 1, dtype=np.float64)
    kernel = -decays[:, None, None] * delta[None] / np.sqrt(ndecay)
    return kernel.astype(np.float32)


def local_attention(x: torch.Tensor, p, num_heads: int = N_HEADS,
                    ndecay: int = N_DECAY) -> torch.Tensor:
    """x: (B, C, T) -> (B, C, T) with the residual added. `p` holds the
    1x1 convs `content`, `query`, `key`, `query_decay` and `proj` (the
    module `models.hdemucs_v3.LocalState`)."""
    B, C, T = x.shape
    H = num_heads
    D = C // H

    q = conv1d(x, p.query.weight, p.query.bias).reshape(B, H, D, T)
    k = conv1d(x, p.key.weight, p.key.bias).reshape(B, H, D, T)
    c = conv1d(x, p.content.weight, p.content.bias).reshape(B, H, D, T)
    decay_q = conv1d(x, p.query_decay.weight, p.query_decay.bias)
    dq = (torch.sigmoid(decay_q) * 0.5).reshape(B, H, ndecay, T)

    # the scale in x's dtype, as the JAX package rounds it
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32).to(x.dtype).item()
    dots = torch.einsum("bhdt,bhds->bhts", k, q) * scale  # t key, s query
    kernel = on_device(decay_kernel, T, ndecay, device=x.device).to(x.dtype)
    dots = dots + torch.einsum("bhns,nts->bhts", dq, kernel)
    eye = torch.eye(T, dtype=torch.bool, device=x.device)
    dots = dots.masked_fill(eye, -100.0)

    weights = torch.softmax(dots.float(), dim=2).to(x.dtype)
    out = torch.einsum("bhts,bhdt->bhds", weights, c).reshape(B, C, T)
    return x + conv1d(out, p.proj.weight, p.proj.bias)

"""Convolutions with PyTorch semantics, in the JAX package's layouts.

The port of the public functions of `demucs_tpu/ops/conv.py`. Each keeps
its JAX counterpart's signature and layout and runs as one `F.conv*`
call: the chunked, tap and blocked lowerings there are TPU layout work,
of which the port keeps the maths, not the form. The frequency-major
helpers take (B, F, C, T) and permute to the (B, C, F, T) view that
`F.conv2d` reads.

Weight layouts follow PyTorch state dicts:
  conv1d:           (out, in, k)
  conv2d:           (out, in, kh, kw)
  conv_transpose1d: (in, out, k)
  conv_transpose2d: (in, out, kh, kw)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x: (B, C, T), w: (O, I/groups, K) -> (B, O, T')."""
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride, padding, dilation, groups)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=(1, 1), padding=(0, 0), dilation=(1, 1),
           groups: int = 1) -> torch.Tensor:
    """x: (B, C, H, W), w: (O, I/groups, KH, KW) -> (B, O, H', W')."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    tuple(stride), tuple(padding), tuple(dilation), groups)


def _to_cmajor(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)          # (B, F, C, T) <-> (B, C, F, T)


def freq_conv_fmajor(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 4,
                     padding: int = 2) -> torch.Tensor:
    """Strided (KH, 1) freq conv on (B, F, C, T); w: (O, I, KH, 1)."""
    y = conv2d(_to_cmajor(x), w, b, (stride, 1), (padding, 0))
    return _to_cmajor(y)


def freq_conv1x1_fmajor(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 conv on (B, F, C, T); w: (O, I, 1, 1) or (O, I)."""
    w4 = w.reshape(w.shape[0], w.shape[1], 1, 1)
    return _to_cmajor(conv2d(_to_cmajor(x), w4, b))


def freq_conv3x3_fmajor(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 conv, padding (1, 1), on (B, F, C, T); w: (O, I, 3, 3)."""
    return _to_cmajor(conv2d(_to_cmajor(x), w, b, padding=(1, 1)))


def freq_convtr_fmajor(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None, stride: int = 4,
                       padding: int = 0) -> torch.Tensor:
    """(KH, 1) transposed conv on (B, F, C, T); w: (I, O, KH, 1)."""
    y = conv_transpose2d(_to_cmajor(x), w, b, (stride, 1), (padding, 0))
    return _to_cmajor(y)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """PyTorch ConvTranspose1d. x: (B, C, T), w: (I, O, K);
    out_len = (T - 1) * stride + K - 2 * padding."""
    return F.conv_transpose1d(x, w.to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              stride, padding)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride=(1, 1),
                     padding=(0, 0)) -> torch.Tensor:
    """PyTorch ConvTranspose2d. x: (B, C, H, W), w: (I, O, KH, KW)."""
    return F.conv_transpose2d(x, w.to(x.dtype),
                              None if b is None else b.to(x.dtype),
                              tuple(stride), tuple(padding))

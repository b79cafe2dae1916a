"""Quantized weights on the modules, and how the ops take them.

A `QuantizedWeight` takes the place of a dense parameter whose state-dict
entry `params.quant` split into `<name>.q` (int8 or float8 e4m3fn, the
weight's shape) and `<name>.scale` (f32, (out, 1, ...)): it holds the two
as buffers, so they move with the model, load strictly by name and shape,
and the weight never lies on the device in f32.

The ops take either form of a weight. An int8 weight in nn.Linear layout
goes straight to the kernel K7 (`ops.attention.linear`); every other
quantized weight, the convolution kernels and every fp8 weight, is widened
where it is used (`dense`) and the temporary is freed after the call.

A `QuantizedWeight` widens to its `dtype`, with the arithmetic of the JAX
package's `dequantize_tree(qparams, dtype)`: q.astype(dtype) *
scale.astype(dtype), in that dtype. float32 by default; bfloat16 on the
`--bf16 --int8` / `--bf16 --fp8` path, whose network still runs in f32
(the JAX package's `quantized_model_fn(fn, bf16)` widens only the
quantized leaves), so each widened weight is cast up at its use.
"""

from __future__ import annotations

import torch
from torch import nn


class QuantizedWeight(nn.Module):
    """A weight held as buffers `q` and `scale`, in place of a parameter,
    widened to `dtype`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.dtype = dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dense(self) -> torch.Tensor:
        """The weight widened: q * scale in `dtype`."""
        return self.q.to(self.dtype) * self.scale.to(self.dtype)

    def chunk(self, chunks: int) -> tuple[QuantizedWeight, ...]:
        """Split along dim 0, each part with its rows' scales, as
        `Tensor.chunk` splits a dense weight."""
        return tuple(QuantizedWeight(q, s, self.dtype)
                     for q, s in zip(self.q.chunk(chunks), self.scale.chunk(chunks)))


def dense(w: torch.Tensor | QuantizedWeight) -> torch.Tensor:
    """A dense weight as it is; a quantized one widened to its dtype."""
    return w.dense() if isinstance(w, QuantizedWeight) else w


def hold_quantized(model: nn.Module, state_dict: dict[str, torch.Tensor],
                   dtype: torch.dtype = torch.float32) -> None:
    """Swap each parameter `name` of `model` for which `state_dict` has a
    `name.q` entry for a `QuantizedWeight` of the parameter's shape, on the
    parameter's device, with the entry's dtype, widened to `dtype`, so that
    `load_state_dict(strict=True)` then checks every name and shape."""
    for name, p in list(model.named_parameters()):
        q = state_dict.get(f"{name}.q")
        if q is None:
            continue
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        delattr(module, attr)
        scale_shape = (p.shape[0],) + (1,) * (p.ndim - 1)
        setattr(module, attr, QuantizedWeight(
            torch.empty(p.shape, dtype=q.dtype, device=p.device),
            torch.empty(scale_shape, dtype=torch.float32, device=p.device), dtype))

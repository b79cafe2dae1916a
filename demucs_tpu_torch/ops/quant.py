"""Quantized weights on the modules, and how the ops take them.

A `QuantizedWeight` takes the place of a dense parameter whose state-dict
entry `params.quant` split into `<name>.q` (int8 or float8 e4m3fn, the
weight's shape) and `<name>.scale` (f32, (out, 1, ...)): it holds the two
as buffers, so they move with the model, load strictly by name and shape,
and the weight never lies on the device in f32.

The ops take either form of a weight. An int8 weight in nn.Linear layout
goes straight to the kernel K7 (`ops.attention.linear`); every other
quantized weight, the convolution kernels and every fp8 weight, is widened
where it is used (`dense`: q * scale in f32, the arithmetic of the JAX
package's `dequantize_tree`) and the temporary is freed after the call.
"""

from __future__ import annotations

import torch
from torch import nn


class QuantizedWeight(nn.Module):
    """A weight held as buffers `q` and `scale`, in place of a parameter."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dense(self) -> torch.Tensor:
        """The weight widened to f32: q * scale."""
        return self.q.float() * self.scale

    def chunk(self, chunks: int) -> tuple[QuantizedWeight, ...]:
        """Split along dim 0, each part with its rows' scales, as
        `Tensor.chunk` splits a dense weight."""
        return tuple(QuantizedWeight(q, s)
                     for q, s in zip(self.q.chunk(chunks), self.scale.chunk(chunks)))


def dense(w: torch.Tensor | QuantizedWeight) -> torch.Tensor:
    """A dense weight as it is; a quantized one widened to f32."""
    return w.dense() if isinstance(w, QuantizedWeight) else w


def hold_quantized(model: nn.Module, state_dict: dict[str, torch.Tensor]) -> None:
    """Swap each parameter `name` of `model` for which `state_dict` has a
    `name.q` entry for a `QuantizedWeight` of the parameter's shape, on the
    parameter's device, with the entry's dtype, so that
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
            torch.empty(scale_shape, dtype=torch.float32, device=p.device)))

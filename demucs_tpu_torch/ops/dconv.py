"""One DConv sub-block, as the models call it.

`dconv_sub_block(x, blk, dil)` runs sub-block `blk` (Demucs' Sequential:
0 conv, 1 norm, 3 conv, 4 norm, 6 LayerScale) of a DConv on x (N, C, T)
through K5's wrapper (`ops.cuda.dconv_sub_block`, a custom op): on CPU
tensors the plain twin, the chain of ops the models always ran; on CUDA
tensors the fused kernel K5. In grad mode the plain twin is called
directly on CPU tensors, which autograd differentiates as before, and
K5 inside `DConvSubBlock` on CUDA tensors.

K5 has no backward kernel (the JAX package has none either). The
Function's backward recomputes the sub-block through the plain twin from
the saved input and weights under autograd and returns its gradients, as
the JAX package's `ops/lstm.py:_rec_bwd` recomputes its recurrence. So a
training step keeps only each sub-block's input for the backward, not
its intermediates; under `torch.no_grad()` the Function is its forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import f32_precision
from .cuda.dconv import dconv_sub_block as _fused
from .cuda.dconv import dconv_sub_block_plain
from .quant import dense


class DConvSubBlock(torch.autograd.Function):
    """forward(x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil): K5 on CUDA
    tensors (the plain twin on CPU tensors); backward: autograd through
    the plain twin, recomputed."""

    @staticmethod
    def forward(ctx, x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil):
        ctx.dil = dil
        ctx.save_for_backward(x, w0, b0, g1, be1, w3, b3, g4, be4, scale)
        return _fused(x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:10]
        with torch.enable_grad(), f32_precision():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = dconv_sub_block_plain(*inputs, ctx.dil)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, needs) if n], grad))
        return (*(next(grads) if n else None for n in needs), None)


def dconv_sub_block(x: torch.Tensor, blk: nn.Sequential, dil: int) -> torch.Tensor:
    """x (N, C, T) -> x + the sub-block's residual branch, (N, C, T). Both
    conv weights are widened first if they are quantized, and every
    weight is taken in x's dtype (a weight widened to bf16 meets f32 x on
    the `--bf16 --int8` path)."""
    weights = tuple(w.to(x.dtype) for w in (
        dense(blk[0].weight), blk[0].bias, blk[1].weight, blk[1].bias,
        dense(blk[3].weight), blk[3].bias, blk[4].weight, blk[4].bias, blk[6].scale))
    cpu = x.device.type == "cpu"
    # the `(b f) c t` fold of a batch of one is a strided view, not a copy
    x = x if cpu else x.contiguous()
    if torch.is_grad_enabled():
        # autograd differentiates the plain twin's ops; K5 through the Function
        return (dconv_sub_block_plain if cpu else DConvSubBlock.apply)(x, *weights, dil)
    return _fused(x, *weights, dil)

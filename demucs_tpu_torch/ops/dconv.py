"""The DConv sub-block and the DConv tail, as the models call them.

`dconv_sub_block(x, blk, dil)` runs sub-block `blk` (Demucs' Sequential:
0 conv, 1 norm, 3 conv, 4 norm, 6 LayerScale) of a DConv on x (N, C, T)
through K5's wrapper (`ops.cuda.dconv_sub_block`, a custom op): on CPU
tensors the plain twin, the chain of ops the models always ran; on CUDA
tensors the fused kernel K5. In grad mode the plain twin is called
directly on CPU tensors, which autograd differentiates as before, and
K5 inside `DConvSubBlock` on CUDA tensors.

`gn_glu_scale_res(y, weight, bias, scale, res)` is the tail of v3's
encoder-4/5 sub-blocks (GroupNorm(1), GLU, LayerScale, residual) through
K4's wrapper; in grad mode it goes through `GnGluScaleRes` on either
device.

Neither kernel has a backward kernel (the JAX package has none either:
it differentiates the XLA form). Both Functions (`ops.recompute`)
recompute their twin from the saved inputs under autograd in the
backward, as the JAX package's `ops/lstm.py:_rec_bwd` recomputes its
recurrence. So a training step keeps only each call's inputs for the
backward, not its intermediates; under `torch.no_grad()` each is its
forward.
"""

from __future__ import annotations

import torch
from torch import nn

from .cuda.dconv import dconv_sub_block as _fused
from .cuda.dconv import dconv_sub_block_plain
from .cuda.dconv import gn_glu_scale_res as _tail
from .cuda.dconv import gn_glu_scale_res_plain
from .quant import dense
from .recompute import recomputed

# forward(x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil): K5
DConvSubBlock = recomputed("DConvSubBlock", _fused, dconv_sub_block_plain, 10)
# forward(y, weight, bias, scale, res): K4
GnGluScaleRes = recomputed("GnGluScaleRes", _tail, gn_glu_scale_res_plain, 5)


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


def gn_glu_scale_res(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) of y (R, 2C, T) -> GLU -> LayerScale -> + res (R, C, T):
    K4 (its twin on CPU tensors), through `GnGluScaleRes` in grad mode."""
    if torch.is_grad_enabled():
        return GnGluScaleRes.apply(y, weight, bias, scale, res)
    return _tail(y, weight, bias, scale, res)

"""Autograd for the forward-only kernels: forward the kernel, backward
autograd through its plain twin, recomputed.

K4, K5 and K6 have no backward kernel, and the JAX package has none
either: it differentiates the XLA form of the DConv and recomputes the
BiLSTM's recurrence through its scan in `demucs_tpu/ops/lstm.py:_rec_bwd`.
`recomputed(kernel, plain, n_tensors)` makes the same thing an
`autograd.Function`: its forward is the kernel's wrapper (the CUDA kernel
on CUDA tensors, the plain twin on CPU tensors; the wrapper raises rather
than fall back), and it keeps only the inputs for the backward. The
backward runs the plain twin on those inputs again under autograd, inside
`f32_precision()` (TF32 off, as in the forward), and returns the
gradients of the inputs that need one. A bf16 call recomputes through the
twin's bf16 form.
"""

from __future__ import annotations

import torch

from ..utils.device import f32_precision


def recomputed(name: str, kernel, plain, n_tensors: int) -> type[torch.autograd.Function]:
    """An `autograd.Function` named `name` whose `apply(*tensors, *rest)`
    takes `n_tensors` tensors and then non-tensor arguments (a dilation),
    returns `kernel(*tensors, *rest)`, and differentiates
    `plain(*tensors, *rest)` in its backward."""

    def forward(ctx, *args):
        ctx.rest = args[n_tensors:]
        ctx.save_for_backward(*args[:n_tensors])
        return kernel(*args)

    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:n_tensors]
        with torch.enable_grad(), f32_precision():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = plain(*inputs, *ctx.rest)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, needs) if n], grad))
        return (*(next(grads) if n else None for n in needs), *(None,) * len(ctx.rest))

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward),
        "__doc__": f"forward: {kernel.__name__} (its CUDA kernel on CUDA tensors, the "
                   f"plain twin on CPU tensors); backward: autograd through "
                   f"{plain.__name__}, recomputed from the saved inputs.",
        "__module__": __name__})

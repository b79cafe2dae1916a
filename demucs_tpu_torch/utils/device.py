"""Device choice and float32 precision for the port's entry points.

`resolve_device` is the counterpart of JAX's platform choice: the entry
points run on "cuda" unless the caller asks for "cpu", and a CUDA
request with no GPU present raises instead of falling back.

`f32_precision` scopes the float32 contract of a model call: cuDNN would
run f32 convolutions in TF32 by default, and the reference the port is
held to is f32, so TF32 is off for convolutions and matrix products
inside the block and restored after it.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but no GPU is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def f32_precision():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block;
    only the flags that were on are touched, and they are turned back on."""
    changed = [flags for flags in (torch.backends.cuda.matmul, torch.backends.cudnn)
               if flags.allow_tf32]
    for flags in changed:
        flags.allow_tf32 = False
    try:
        yield
    finally:
        for flags in changed:
            flags.allow_tf32 = True

"""Device choice and float32 precision for the port's entry points.

`resolve_device` is the counterpart of JAX's platform choice: the entry
points run on "cuda" unless the caller asks for "cpu", and a CUDA
request with no GPU present raises instead of falling back.

`f32_precision` scopes the float32 contract of a model call: cuDNN would
run f32 convolutions in TF32 by default, and the reference the port is
held to is f32, so TF32 is off for convolutions and matrix products
inside the block and restored after it.

`deterministic_cudnn` scopes the reproducibility contract of a training
step: cuDNN may otherwise pick, or benchmark its way to, convolution
algorithms whose sums (atomics, split reductions) change order between
runs, and a resumed run must equal an uninterrupted one bit for bit, as
the JAX package's does.

`on_device` keeps the graphs' numpy constants (windows, embeddings,
decay bases) on the device, uploaded once per shape.
"""

from __future__ import annotations

import contextlib
import functools

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


def on_device(make, *key, device: str | torch.device) -> torch.Tensor:
    """`make(*key)` (a numpy constant) on `device`, uploaded once per key
    and device: a copy from pageable host memory waits for the device's
    queue to drain, which on every call would stall the host in the middle
    of the graph (and with it the launch of the next batch). Made outside
    inference mode, so that training can use it too; the caller must not
    modify it."""
    return _on_device(make, key, torch.device(device))


@functools.lru_cache(maxsize=64)
def _on_device(make, key, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(make(*key)).to(device)


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms only, and no autotuning, inside the
    block: `torch.backends.cudnn.deterministic` on and `benchmark` off.
    Only the flags that differed are touched, and they are put back."""
    flags = torch.backends.cudnn
    changed = [(name, getattr(flags, name)) for name, want in
               (("deterministic", True), ("benchmark", False))
               if getattr(flags, name) != want]
    for name, was in changed:
        setattr(flags, name, not was)
    try:
        yield
    finally:
        for name, was in changed:
            setattr(flags, name, was)

"""Seeded weights, made on the device in a few large calls.

The recipe is `params/tree.py:init_flat`'s, per weight name: LayerScale
(`scale`) near 0.5, norm weights (1-D `weight`) near one, biases near
zero, every other weight normal with std 0.1 / sqrt(fan_in), so that a
random network stays numerically sane through its 50+ layers. The
numbers are drawn by one `torch.randn` over all weights from a
`torch.Generator` on the device, then scaled and offset per weight, so
the same seed gives the same weights on every run and on both sides of
a comparison.
"""

from __future__ import annotations

import math

import torch

NORM_SUFFIXES = ("norm1.weight", "norm2.weight", "norm3.weight", "norm_out.weight",
                 "norm_in.weight", "norm_in_t.weight")


def recipe(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """(std, mean) of one weight's entries."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return 0.01, 0.5
    if len(shape) == 1 and (name.endswith(NORM_SUFFIXES) or leaf == "weight"):
        return 0.02, 1.0
    if "bias" in leaf:
        return 0.01, 0.0
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
    return 0.1 / math.sqrt(max(fan_in, 1)), 0.0


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on `device` for `seed` (any whole number; taken modulo
    2**63), kept apart from the other draws of a run by `salt`."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + salt) % 2**63)


def seeded_state_dict(shapes: list[tuple[str, tuple[int, ...]]], seed: int,
                      device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor on device} for the (name, shape) list."""
    counts = [math.prod(s) for _, s in shapes]
    stds, means = zip(*(recipe(n, s) for n, s in shapes))
    n = torch.tensor(counts, device=device)
    flat = torch.randn(sum(counts), generator=generator(seed, device), device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), n))
    flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), n))
    out, pos = {}, 0
    for (name, shape), c in zip(shapes, counts):
        out[name] = flat[pos:pos + c].view(shape)
        pos += c
    return out

"""BagOfModels: the htdemucs_ft ensemble (four fine-tuned models, one stem
each).

The port of `demucs_tpu/models/bag.py`. The JAX package stacks the
models' parameter trees on a leading axis and maps the segment graph
over it inside one program, then keeps model i's stem i (`bag_select`).
Here the models are `nn.Module`s in a `ModuleList`: `BagOfModels` runs
model i and keeps its stem i at once, which gives the numbers of
`bag_select(unrolled_model_map(...))` without holding every model's
full (B, S, C, L) output. `unrolled_model_map` and `bag_select` keep the
JAX names for a reader who looks for them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from . import build_model


def unrolled_model_map(models, mix: torch.Tensor) -> torch.Tensor:
    """Every model on `mix` (B, C, L) -> (M, B, S, C, L)."""
    return torch.stack([model(mix) for model in models])


def bag_select(per_model: torch.Tensor) -> torch.Tensor:
    """(M, B, S, C, L) -> (B, S, C, L): model i's stem i (the ft
    convention). Requires M == S."""
    M, _, S = per_model.shape[:3]
    if M != S:
        raise ValueError(f"a bag of {M} models needs {M} stems per model, got {S}")
    return torch.stack([per_model[i, :, i] for i in range(M)], dim=1)


class BagOfModels(nn.Module):
    """forward(mix (B, C, L)) -> (B, M, C, L): stem i from model i, for M
    models of M stems each."""

    def __init__(self, models):
        super().__init__()
        self.models = nn.ModuleList(models)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        M = len(self.models)
        stems = []
        for i, model in enumerate(self.models):
            y = model(mix)
            if y.shape[1] != M:
                raise ValueError(f"a bag of {M} models needs {M} stems per model, "
                                 f"got {y.shape[1]}")
            stems.append(y[:, i])
        return torch.stack(stems, dim=1)


def build_bag(cfg, state_dicts, device: str | torch.device = "cuda",
              quant_dtype: torch.dtype = torch.float32, tp_group=None) -> BagOfModels:
    """A BagOfModels on `device` ("cuda" unless the caller asks for "cpu";
    without a GPU a CUDA request raises): each state dict loaded (strictly, by
    `build_model`) into a model of the one config `cfg`, as the JAX CLI
    builds every model with the first file's config; a state dict of
    another shape raises ValueError naming its model. `tp_group`, as
    `build_model` takes it: the state dicts are this rank's slices."""
    if len(state_dicts) != cfg.num_sources:
        raise ValueError(f"a bag of {cfg.num_sources}-stem models needs "
                         f"{cfg.num_sources} of them, got {len(state_dicts)}")
    device = resolve_device(device)
    models = []
    for i, sd in enumerate(state_dicts):
        try:
            models.append(build_model(cfg, sd, device, quant_dtype, tp_group=tp_group))
        except RuntimeError as e:
            raise ValueError(f"bag model {i} does not fit the first model's config: {e}") \
                from e
    return BagOfModels(models)

"""Separation over a mesh of ranks.

The port of `demucs_tpu/parallel/separator.py`. Every rank holds the
whole track and runs the same host side (`pipeline.Separator`: split,
batches, overlap-add); the device side of each model call is split over
the mesh:

  * `make_sharded_fn`: the segment batch over ``dp`` (padded to a
    multiple of dp, each rank running its slice, the outputs gathered so
    that every rank holds the whole batch, the pad cut off), the model
    tensor-parallel over ``tp`` where it was built with the tp group;
  * `make_bag_fn`: the fine-tuned bag over ``bag``, each group of ranks
    running its models unrolled on its dp slice, the per-model outputs
    gathered over bag and then selected (`models.bag.bag_select`);
  * `ShardedSeparator`: `pipeline.Separator` over one of those, its batch
    rounded up to a multiple of dp. Its batched path calls the split
    model once a batch (`Separator._call_device`), and its fused
    whole-track pass once a sub-batch of `batch_size` segments, so each
    rank runs its dp share of every call (the counterpart of the JAX
    class's `_fused_model_call`).

The collectives run inside the model call, which `Separator` makes under
`torch.inference_mode()`: the gathered tensors are made there too.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.bag import bag_select, unrolled_model_map
from ..pipeline import ApplyOptions, Separator
from .mesh import axis_group, axis_rank, axis_size


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's `x` of `group` (of n ranks), concatenated on dim 0 in
    rank order; `x` itself for one rank."""
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _DataParallel(nn.Module):
    """The dp split of a batch-first call, around `run(local batch)`."""

    def __init__(self, mesh):
        super().__init__()
        self.dp = axis_size(mesh, "dp")
        self.dp_rank = axis_rank(mesh, "dp")
        self.dp_group = axis_group(mesh, "dp")

    def _local(self, mix: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `mix`, zero-padded to a multiple of dp."""
        n = math.ceil(mix.shape[0] / self.dp)
        pad = n * self.dp - mix.shape[0]
        if pad:
            mix = F.pad(mix, (0, 0) * (mix.ndim - 1) + (0, pad))
        return mix[self.dp_rank * n:(self.dp_rank + 1) * n]

    def _whole(self, y: torch.Tensor, batch: int) -> torch.Tensor:
        return _gather(y, self.dp_group, self.dp)[:batch]


class _ShardedModel(_DataParallel):
    """forward(mix (B, C, L)) -> (B, S, C, L) on every rank: `model` (this
    rank's, tensor-parallel if it was built with the tp group) on this
    rank's dp slice, the slices gathered."""

    def __init__(self, model: nn.Module, mesh):
        super().__init__(mesh)
        self.model = model

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        return self._whole(self.model(self._local(mix)), mix.shape[0])


class _ShardedBag(_DataParallel):
    """forward(mix (B, C, L)) -> (B, M, C, L) on every rank: this bag
    group's models (M / bag of the bag's M, the group's share in order)
    run unrolled on this rank's dp slice, the per-model outputs (M, B, S,
    C, L) gathered over bag and `select`ed (default `bag_select`: model
    i's stem i)."""

    def __init__(self, models, mesh, select=None):
        super().__init__(mesh)
        self.models = nn.ModuleList(models)
        self.bag = axis_size(mesh, "bag")
        self.bag_group = axis_group(mesh, "bag")
        self.select = select or bag_select

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        per_model = _gather(unrolled_model_map(self.models, self._local(mix)),
                            self.bag_group, self.bag)
        return self._whole(self.select(per_model), mix.shape[0])


def bag_share(mesh, n_models: int) -> range:
    """The models of a bag of `n_models` that this rank's bag group holds."""
    bag = axis_size(mesh, "bag")
    if n_models % bag:
        raise ValueError(f"{n_models} models not divisible by bag={bag}")
    per = n_models // bag
    g = axis_rank(mesh, "bag")
    return range(g * per, (g + 1) * per)


def make_sharded_fn(model: nn.Module, mesh) -> nn.Module:
    """`model` split over the mesh's dp axis (and over tp where it holds
    this rank's tp share): B need not divide by dp."""
    return _ShardedModel(model, mesh)


def make_bag_fn(models, mesh, select=None) -> nn.Module:
    """The bag over the mesh's bag axis: `models` are this rank's bag
    group's share (`bag_share`)."""
    return _ShardedBag(models, mesh, select)


class ShardedSeparator(Separator):
    """`pipeline.Separator` whose model calls are split over `mesh`.

    `model` is this rank's model (built with the mesh's tp group where
    tp > 1); with `bag_stacked`, a sequence of this rank's bag group's
    models (`bag_share`), the bag split over the bag axis. The options'
    batch_size is rounded up to a multiple of dp on a copy; the caller's
    object is not touched. Every rank must make the same calls on the
    same tracks, and every rank gets the whole result."""

    def __init__(self, model, num_sources: int, mesh, options: ApplyOptions | None = None,
                 bag_stacked: bool = False, device: str | torch.device = "cuda"):
        options = options or ApplyOptions()
        dp = axis_size(mesh, "dp")
        options = dataclasses.replace(
            options, batch_size=max(dp, math.ceil(options.batch_size / dp) * dp))
        fn = make_bag_fn(model, mesh) if bag_stacked else make_sharded_fn(model, mesh)
        super().__init__(fn, num_sources, options, device)
        self.mesh = mesh

    def _fused_auto_sub(self) -> int:
        """A sub-batch of the fused pass covers the dp axis: batch_size,
        which is a multiple of dp."""
        return max(1, self.options.batch_size)

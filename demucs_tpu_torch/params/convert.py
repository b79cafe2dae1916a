"""Carry weights from the JAX package's parameter trees to the port.

`demucs_tpu` keeps weights as a nested pytree (or a flat dict) of numpy
or JAX arrays under PyTorch state-dict names; the port keeps them in
`nn.Module`s. `from_jax_params` turns the former into a state dict for
the latter, so both packages can run on the same weights. It reads the
arrays through `np.asarray` and imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import flatten_tree


def from_jax_params(tree_or_flat) -> dict[str, torch.Tensor]:
    """Nested pytree or flat dict of arrays -> {name: float32 CPU tensor}."""
    flat = flatten_tree(tree_or_flat)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32))
            for name, arr in flat.items()}

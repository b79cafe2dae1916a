"""Carry weights from the JAX package's parameter trees to the port, and
cast a state dict to another float type.

`demucs_tpu` keeps weights as a nested pytree (or a flat dict) of numpy
or JAX arrays under PyTorch state-dict names; the port keeps them in
`nn.Module`s. `from_jax_params` turns the former into a state dict for
the latter, so both packages can run on the same weights. It reads the
arrays through `np.asarray` and imports nothing of JAX.

`from_jax_bag_params` does the same for the fine-tuned bag, whose trees
the JAX package stacks on a leading models axis
(`demucs_tpu.models.bag.stack_bag_params`): one state dict per model,
since the port keeps a bag as a list of modules (`models.BagOfModels`).

`cast_state_dict` is the port's counterpart of the JAX CLI's `--bf16`
tree map (`jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)`).
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import flatten_tree


# ml_dtypes' 1- and 2-byte types, carried by their bits: (bit view, torch dtype)
_BIT_TYPES = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name in _BIT_TYPES:
        view, dtype = _BIT_TYPES[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(view).copy()).view(dtype)
    if a.dtype == np.int8:  # a quantized weight's `q`
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_params(tree_or_flat) -> dict[str, torch.Tensor]:
    """Nested pytree or flat dict of arrays -> {name: CPU tensor}: a
    bfloat16 leaf becomes a torch.bfloat16 tensor bit for bit, as do the
    int8 and float8 e4m3 `q` leaves of a quantized tree in their own
    types; every other leaf becomes a float32 one."""
    return {name: _tensor(arr) for name, arr in flatten_tree(tree_or_flat).items()}


def from_jax_bag_params(stacked) -> list[dict[str, torch.Tensor]]:
    """A stacked bag tree (every leaf with a leading models axis of M, as
    `stack_bag_params` makes it, quantized or cast trees included) -> M
    state dicts, model i's entries the slices [i] of the leaves, carried
    as `from_jax_params` carries a leaf."""
    flat = {name: np.asarray(arr) for name, arr in flatten_tree(stacked).items()}
    sizes = {arr.shape[0] for arr in flat.values()}
    if len(sizes) != 1:
        raise ValueError(f"the leaves' leading (models) axes differ: {sorted(sizes)}")
    return [{name: _tensor(arr[i]) for name, arr in flat.items()} for i in range(sizes.pop())]


def cast_state_dict(state_dict: dict[str, torch.Tensor],
                    dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every floating entry cast to `dtype` (round to nearest even, as
    `jnp.asarray(x, jnp.bfloat16)` rounds); the `<name>.q` and
    `<name>.scale` pair of a quantized weight (`params.quant`) is left as
    it is."""
    held = {name[:-2] for name in state_dict if name.endswith(".q")}

    def keep(name: str, t: torch.Tensor) -> bool:
        return (not t.is_floating_point() or name[:-2] in held
                or (name.endswith(".scale") and name[:-6] in held))

    return {name: t if keep(name, t) else t.to(dtype) for name, t in state_dict.items()}

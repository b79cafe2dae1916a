"""Carry weights from the JAX package's parameter trees to the port, and
cast a state dict to another float type.

`demucs_tpu` keeps weights as a nested pytree (or a flat dict) of numpy
or JAX arrays under PyTorch state-dict names; the port keeps them in
`nn.Module`s. `from_jax_params` turns the former into a state dict for
the latter, so both packages can run on the same weights. It reads the
arrays through `np.asarray` and imports nothing of JAX.

`cast_state_dict` is the port's counterpart of the JAX CLI's `--bf16`
tree map (`jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)`).
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import flatten_tree


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: its 16 bits, unchanged
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_params(tree_or_flat) -> dict[str, torch.Tensor]:
    """Nested pytree or flat dict of arrays -> {name: CPU tensor}: a
    bfloat16 leaf becomes a torch.bfloat16 tensor bit for bit, every
    other leaf a float32 one."""
    return {name: _tensor(arr) for name, arr in flatten_tree(tree_or_flat).items()}


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

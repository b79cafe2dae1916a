"""Flat state-dict <-> nested tree conversion, checks, random init.

The port's copy of `demucs_tpu/params/tree.py`. One difference: in the
JAX package `from_state_dict` nests the weights into the pytree that the
model functions take, while here the nesting is the `nn.Module` tree
itself, so `from_state_dict` returns the checked flat state dict of
torch tensors that `HTDemucs.load_state_dict` takes.

A path component becomes a list index iff the components at that level
are a dense 0..n-1 integer range (e.g. "encoder.0", "dconv.layers.1");
sparse numeric keys (the torch nn.Sequential indices 0/1/3/4/6) stay
string dict keys.
"""

from __future__ import annotations

import numpy as np
import torch


def unflatten_tree(flat: dict[str, np.ndarray]):
    """{'a.0.b': x} -> {'a': [{'b': x}]} with dense-list detection."""
    root: dict = {}
    for name, value in flat.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def densify(node):
        if not isinstance(node, dict):
            return node
        node = {k: densify(v) for k, v in node.items()}
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node

    return densify(root)


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Inverse of unflatten_tree."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = node

    walk(tree, prefix)
    return out


def from_state_dict(sd: dict[str, np.ndarray],
                    schema: dict[str, tuple]) -> dict[str, torch.Tensor]:
    """Check a flat state dict against the schema -> {name: f32 CPU tensor}.

    Tensors are reshaped to the schema's full shapes, which undoes the
    squeeze applied by the ggml writer. Raises on missing, extra or
    mis-sized tensors.
    """
    missing = set(schema) - set(sd)
    extra = set(sd) - set(schema)
    if missing:
        raise ValueError(f"missing {len(missing)} tensors, e.g. {sorted(missing)[:5]}")
    if extra:
        raise ValueError(f"unexpected {len(extra)} tensors, e.g. {sorted(extra)[:5]}")
    out = {}
    for name, shape in schema.items():
        arr = np.asarray(sd[name])
        if arr.size != int(np.prod(shape)):
            raise ValueError(
                f"{name}: got {arr.shape} ({arr.size} elems), want {shape}")
        arr = np.ascontiguousarray(arr.reshape(shape).astype(np.float32))
        out[name] = torch.from_numpy(arr)
    return out


def init_flat(schema: dict[str, tuple], seed: int = 0, scale: float = 0.1,
              dtype=np.float32):
    """Random flat state dict of numpy arrays (tests / smoke runs).

    Bit-identical to `demucs_tpu.params.init_flat` for the same seed.
    Norm weights and LayerScale get near-one values, biases near zero,
    so random networks stay numerically sane through 50+ layers.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in schema.items():
        leaf = name.rsplit(".", 1)[-1]
        is_norm_like = len(shape) == 1 and (
            name.endswith("norm1.weight") or name.endswith("norm2.weight")
            or name.endswith("norm3.weight") or name.endswith("norm_out.weight")
            or name.endswith("norm_in.weight") or name.endswith("norm_in_t.weight")
            or (leaf == "weight" and len(shape) == 1))
        if leaf == "scale":
            arr = np.full(shape, 0.5, dtype) + rng.standard_normal(shape).astype(dtype) * 0.01
        elif is_norm_like:
            arr = np.ones(shape, dtype) + rng.standard_normal(shape).astype(dtype) * 0.02
        elif leaf == "bias" or "bias" in leaf:
            arr = rng.standard_normal(shape).astype(dtype) * 0.01
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            arr = rng.standard_normal(shape).astype(dtype) * (scale / np.sqrt(max(fan_in, 1)))
        flat[name] = arr
    return flat

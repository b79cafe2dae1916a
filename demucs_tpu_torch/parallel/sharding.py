"""Which state-dict entries tensor parallelism shards, and how.

The port of `demucs_tpu/parallel/sharding.py`. Weights are small, so
everything is replicated but the transformer's projections, which hold
most of its products: Megatron-style, `in_proj` (the packed Q/K/V) and
`linear1` split their output rows ("column parallel"), `linear2` and
`out_proj` their input columns ("row parallel"), whose partial products
`ops/attention.py` all-reduces over the tp group. `tp_dim` is the JAX
package's `_tp_rule` on state-dict names: it picks the same entries, on
the same dimensions, and nothing of hdemucs_mmi (v3), which has none of
these names.

Two things the JAX package leaves to its compiler are explicit here:

  * the packed in_proj_weight (3C, C) is not cut as one block of rows
    (which would give rank 0 all of Q and half of K): each rank takes its
    heads' rows of Q, of K and of V, packed again as [Q_r; K_r; V_r];
  * a quantized entry (`name.q`, `name.scale`, `params.quant`) is
    sharded too: a row-split weight's q with its rows' scales, a
    column-split weight's q columns with the whole scale (its scales are
    per output row). The JAX rule leaves quantized leaves replicated, so
    its result is the dense product, which the sharded one equals up to
    the order of the sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_group, axis_rank, axis_size

_PACKED = ("in_proj_weight", "in_proj_bias")


def _candidate(name: str) -> int | None:
    """The dimension tp would shard entry `name` on, by its name alone."""
    if name.endswith(_PACKED):
        return 0
    if "linear1" in name and name.endswith(("weight", "bias")):
        return 0
    if ("linear2" in name or "out_proj" in name) and name.endswith("weight"):
        return 1
    return None


def tp_dim(name: str, shape, tp: int) -> int | None:
    """The dimension of the dense entry `name` of (full) `shape` that a tp
    degree of `tp` shards, or None where it stays replicated: the JAX
    package's `_tp_rule` (a dimension that tp does not divide stays
    whole)."""
    d = _candidate(name)
    if tp > 1 and d is not None and len(shape) > d and shape[d] % tp == 0:
        return d
    return None


def shard_tensor(name: str, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s part (of `tp`) of the dense full entry `name`; the
    entry itself where tp leaves it whole."""
    d = tp_dim(name, t.shape, tp)
    if d is None:
        return t
    if name.endswith(_PACKED):  # [Q; K; V]: this rank's heads of each
        return torch.cat([part.chunk(tp)[rank] for part in t.chunk(3)]).contiguous()
    return t.chunk(tp, dim=d)[rank].contiguous()


def _quantized_base(name: str, state_dict: dict) -> tuple[str, str | None]:
    """("w", "q") / ("w", "scale") for the pair of a quantized weight `w`,
    else (name, None)."""
    base, _, suffix = name.rpartition(".")
    if suffix in ("q", "scale") and f"{base}.q" in state_dict and f"{base}.scale" in state_dict:
        return base, suffix
    return name, None


def shard_state_dict(state_dict: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """This rank's slice of a full state dict (dense or quantized by
    `params.quant`) over the mesh's tp axis: what `build_model(...,
    tp_group=...)` loads. Without tp (or a mesh), the state dict itself."""
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return state_dict
    rank = axis_rank(mesh, "tp")
    out = {}
    for name, t in state_dict.items():
        base, part = _quantized_base(name, state_dict)
        if part is None:
            out[name] = shard_tensor(name, t, tp, rank)
            continue
        d = tp_dim(base, state_dict[f"{base}.q"].shape, tp)
        if d is None or (part == "scale" and d == 1):
            out[name] = t  # a column split keeps every output row, so every row's scale
        else:
            out[name] = shard_tensor(base, t, tp, rank)
    return out


def gather_tensor(name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """The full dense entry `name` from every tp rank's part `t` (a
    collective over the tp group: every rank calls it); `t` where tp
    leaves the entry whole."""
    tp = axis_size(mesh, "tp")
    d = _candidate(name)
    if tp == 1 or d is None or t.ndim <= d:
        return t
    full = list(t.shape)
    full[d] *= tp
    if tp_dim(name, full, tp) is None:
        return t
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t.detach().contiguous(), group=axis_group(mesh, "tp"))
    if name.endswith(_PACKED):  # each part [Q_r; K_r; V_r] -> [Q; K; V]
        return torch.cat([torch.cat([p.chunk(3)[i] for p in parts]) for i in range(3)])
    return torch.cat(parts, dim=d)


def gather_state_dict(state_dict: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """The full dense state dict from every tp rank's slice (a collective:
    every rank calls it, with the same names in the same order)."""
    return {name: gather_tensor(name, t, mesh) for name, t in state_dict.items()}

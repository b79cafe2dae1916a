"""The system under test, built from a configuration file: the port's
config object, its model holding the seeded weights, and the
`ApplyOptions` of a traffic mix. The only module of the harness that
imports the program (`demucs_tpu_torch`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference.models import weight_shapes
from .weights import seeded_state_dict


def port_config(cfg: dict):
    """The port's frozen config dataclass named by the file's `program`
    (a class of `demucs_tpu_torch.config`), holding the file's values of
    its fields (lists as tuples)."""
    from demucs_tpu_torch import config as C

    cls = getattr(C, cfg["program"])
    return cls(**{f.name: tuple(cfg[f.name]) if isinstance(cfg[f.name], list) else cfg[f.name]
                  for f in dataclasses.fields(cls) if f.name in cfg})


def seeded_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return seeded_state_dict(weight_shapes(cfg), seed, device)


def build(cfg: dict, weights: dict, device, train: bool = False) -> torch.nn.Module:
    """The port's model of `cfg` holding `weights` (for training, its own
    copy of them)."""
    from demucs_tpu_torch.models import build_model

    return build_model(port_config(cfg), weights, device, train=train)


def apply_options(cfg: dict, options: dict):
    """`pipeline.ApplyOptions` with the configuration's track conventions
    and the mix's device options."""
    from demucs_tpu_torch.pipeline import ApplyOptions

    a = cfg["apply"]
    return ApplyOptions(segment_samples=a["segment_samples"], overlap=a["overlap"],
                        transition_power=a["transition_power"],
                        max_shift_secs=a["max_shift_secs"], shift_seed=a["shift_seed"],
                        **options)

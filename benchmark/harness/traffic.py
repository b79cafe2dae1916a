"""The one generator of traffic: every mix is a data file of parameters
(`benchmark/traffic/<name>.json`) that this module reads.

Every seed gets the same set of sizes, in another order: song lengths
are the quantiles of the mix's distribution at (i + 0.5) / count (an
offline mix gives every call of `count` songs the same set), permuted
by the seed. So the seed changes which song comes when and what it
sounds like, not how much work a run holds.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def length_quantiles(spec: dict, count: int) -> list[float]:
    """`count` song lengths in seconds: quantiles of a log-normal with
    median `median_s` and log-std `sigma`, clipped to [min_s, max_s]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    mu, sigma = math.log(spec["median_s"]), spec["sigma"]
    unit = NormalDist()
    return [min(max(math.exp(mu + sigma * unit.inv_cdf((i + 0.5) / count)), spec["min_s"]),
                spec["max_s"]) for i in range(count)]


def song_lengths(spec: dict, count: int, seed: int, batch: int = 0) -> list[float]:
    """The quantiles, in the seed's order (a new order for each `batch`)."""
    q = length_quantiles(spec, count)
    return [q[i] for i in rng(seed, 1000 + batch).permutation(count)]

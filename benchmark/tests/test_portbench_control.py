"""Each cell's control on the card, at the cell's own size: the
reference computed with TF32 on in the program's place fails one of the
cell's numbers, and the program's own reading stays inside every limit
(for training also the planted fault that leaves half of each batch
out). `benchmark/calibrate.py` takes the same readings over many seeds;
this keeps one seed of each as a test. Skips without a CUDA device."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import core


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in core.spec()["workloads"]])
def test_control_fails_and_program_passes(card, workload):
    limits = core.load_json(core.limits_file(workload))
    r = calibrate.readings(workload, 3_900_000_001, 4.0, card)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
    if "half_batch" in r:
        assert any(r["half_batch"][k] > v for k, v in limits.items()), r

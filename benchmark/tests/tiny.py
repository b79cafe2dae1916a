"""Tiny cells for the harness's CPU tests: the full-width files cut to a
narrow htdemucs-4s (8 channels, a 64-wide transformer) on 16384-sample
segments, songs of 0.5-3 s and training batches of 2."""

from __future__ import annotations

import time

import torch

from benchmark import run as run_py
from benchmark.harness import core

SEGMENT = 16384


def config() -> dict:
    cfg = core.load_json(core.BENCH / "configs" / "htdemucs_4s.json")
    cfg.update(channels=8, bottom_channels=64, operations_per_segment=1,
               training_operations_per_segment=1)
    cfg["apply"] = dict(cfg["apply"], segment_samples=SEGMENT,
                        max_shift_secs=SEGMENT / cfg["apply"]["sample_rate"] / 4)
    return cfg


def offline_mix() -> dict:
    mix = core.load_json(core.traffic_file("offline_songs"))
    mix.update(lengths=dict(mix["lengths"], median_s=1.2, min_s=0.5, max_s=3.0), per_call=3,
               base_audio_s=10.0)
    return mix


def train_mix() -> dict:
    mix = core.load_json(core.traffic_file("train_segments"))
    mix.update(batch=2, tracks=2, track_s=1.0)
    return mix


# limits of the tiny train cell: a narrow model's gradients are mostly
# round-off (its median leaf's norm is ~1e-9), so its gradient and change
# gaps swing up to ~3 on sound runs and are not held here; its loss gap
# (sound runs ~1e-7) separates the faults
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e9, "change_gap": 1e9}


def execute(workload: str, mix: dict, limits: dict, seed: int = 2**31 + 11,
            seconds: float = 1.0, trace: bool = False) -> dict:
    bench = core.spec()
    entry = core.workload_entry(bench, workload)
    return run_py.execute(entry, config(), mix, limits, bench, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter())

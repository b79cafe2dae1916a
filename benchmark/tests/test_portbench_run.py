"""Whole runs of the harness on the CPU at a tiny size, without its look
for a chip: a sound run comes out correct, and the same run with the
timed path broken underneath comes out not correct, once for each fault
a cell can have (an answer altered where it is produced; a training step
that leaves its state unchanged; half of each batch left out). One chip
holds each cell, so no exchange between chips can be left out. Then the
command's refusals: no CUDA device, no program beside it, and no module
of JAX or of the JAX package once a run has closed."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import core

from . import tiny

OFFLINE_LIMITS = core.load_json(core.limits_file("htdemucs_4s.offline"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_offline_sound_run_is_correct_and_reports_its_metrics():
    res = tiny.execute("htdemucs_4s.offline", tiny.offline_mix(), OFFLINE_LIMITS)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"separate_audio_s_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["stem_rel_err"]["value"] < OFFLINE_LIMITS["stem_rel_err"]


def test_offline_answer_altered_where_produced_is_not_correct(monkeypatch):
    from demucs_tpu_torch import pipeline

    forward = pipeline.FusedTrackProgram.forward

    def altered(self, x, n_true):
        y = forward(self, x, n_true)
        y[0, 0, y.shape[-1] // 2] += 1e-2
        return y

    monkeypatch.setattr(pipeline.FusedTrackProgram, "forward", altered)
    res = tiny.execute("htdemucs_4s.offline", tiny.offline_mix(), OFFLINE_LIMITS)
    assert not res["correct"]


def test_offline_trace_run_reports_its_layer_metrics_and_breakdown():
    res = tiny.execute("htdemucs_4s.offline", tiny.offline_mix(), OFFLINE_LIMITS,
                       seconds=4.0, trace=True)
    assert res["correct"] and "breakdown" in res
    assert res["device"]["window_s"] > 0
    # a CPU run has no device time: the readers of device metrics find nothing
    assert res["metrics"] == {}


def test_train_sound_run_is_correct():
    res = tiny.execute("htdemucs_4s.train", tiny.train_mix(), tiny.TRAIN_LIMITS)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"train_audio_s_per_s", "setup_s"}


def test_train_step_leaving_its_state_unchanged_is_not_correct(monkeypatch):
    from demucs_tpu_torch import train

    def unchanged(self, mix, refs):
        with torch.no_grad():
            return train.l1_loss(self.model, mix, refs)

    monkeypatch.setattr(train.TrainStep, "__call__", unchanged)
    res = tiny.execute("htdemucs_4s.train", tiny.train_mix(), tiny.TRAIN_LIMITS)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from demucs_tpu_torch import train

    l1_loss = train.l1_loss

    def half(model, mix, refs, **kw):
        n = mix.shape[0] // 2
        return l1_loss(model, mix[:n], refs[:n], **kw)

    monkeypatch.setattr(train, "l1_loss", half)
    res = tiny.execute("htdemucs_4s.train", tiny.train_mix(), tiny.TRAIN_LIMITS)
    assert not res["correct"]


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark.harness import core
from benchmark.tests import tiny
res = tiny.execute("htdemucs_4s.offline", tiny.offline_mix(), tiny.core.load_json(
    core.limits_file("htdemucs_4s.offline")))
print(json.dumps({{"correct": res["correct"], "loaded": core.forbidden_loaded(),
                  "jax": [m for m in sys.modules if m.split(".")[0] in ("jax", "demucs_tpu")]}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(core.ROOT))],
                         capture_output=True, text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "loaded": [], "jax": []}


def _command(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "htdemucs_4s.offline", "--seed", "1", "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_the_command_refuses_without_a_cuda_device():
    out = _command(core.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_the_command_refuses_beside_no_program(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_work"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "program" in out.stderr

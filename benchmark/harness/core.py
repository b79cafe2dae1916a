"""What a run carries from its driver to the readers and the result line,
and the files the harness finds by name.

    BENCHMARK.json                      cells, metrics, run_seconds
    benchmark/configs/<config>.json     a configuration's sizes
    benchmark/traffic/<traffic>.json    a mix's parameters; "driver" names
                                        benchmark/drivers/<driver>.py
    benchmark/limits/<workload>.json    the limit of each compared number
    benchmark/metrics/<metric>.py       one reader per per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# whole top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "demucs_tpu")


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    cfg: dict
    traffic: dict
    attempted: int = 0
    failed: int = 0
    setup_s: float | None = None
    window_s: float | None = None
    e2e: dict = dataclasses.field(default_factory=dict)       # end-to-end values
    counters: dict = dataclasses.field(default_factory=dict)  # what the window did
    summary: object = None                                    # trace.Summary
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)    # compared numbers


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}")


def config_file(bench: dict, config: str) -> Path:
    return ROOT / next(c["file"] for c in bench["configs"] if c["name"] == config)


def traffic_file(traffic: str) -> Path:
    return BENCH / "traffic" / f"{traffic}.json"


def limits_file(workload: str) -> Path:
    return BENCH / "limits" / f"{workload}.json"


def reader_file(metric: str) -> Path:
    return BENCH / "metrics" / f"{metric}.py"


def applies(metric: dict, workload: str, e2e_names: set[str]) -> bool:
    """Whether a metric is reported in this cell: it lists the cell, or
    lists no cells and the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def e2e_metrics(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if applies(m, workload, {m["name"]})]


def layer_metrics(bench: dict, workload: str) -> list[dict]:
    names = {m["name"] for m in e2e_metrics(bench, workload)}
    return [m for m in bench["per_layer"] if applies(m, workload, names)]


def read_metric(name: str, run: Run):
    """The reader `benchmark/metrics/<name>.py`'s `read(run)`: a number, or
    None where it found nothing to read."""
    spec_ = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                   reader_file(name))
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module.read(run)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(len(s) * q / 100) - 1))]

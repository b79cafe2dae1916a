"""BENCHMARK.json against the contract's forms, and every file the
harness finds by name."""

from __future__ import annotations

import importlib
import json
import re

import torch

from benchmark.harness import core, program
from benchmark.reference import models

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "metric": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_units_and_lines():
    bench = core.spec()
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert _line(c["why"]) and _line(c["source"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["metric"]
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and _line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    bench = core.spec()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in core.e2e_metrics(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.layer_metrics(bench, w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in {x["name"] for x in bench["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name():
    bench = core.spec()
    for c in bench["configs"]:
        cfg = core.load_json(core.ROOT / c["file"])
        assert type(program.port_config(cfg)).__name__ == cfg["program"]
        with torch.device("meta"), models.uninitialized():
            ref = models.reference_model(cfg)
        assert type(ref).__name__ == cfg["reference"].split(":")[1]
    for w in bench["workloads"]:
        mix = core.load_json(core.traffic_file(w["traffic"]))
        driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
        assert callable(driver.measure) and callable(driver.check)
        limits = core.load_json(core.limits_file(w["name"]))
        assert limits and all(v > 0 for v in limits.values())
        core.config_file(bench, w["config"]).is_file()
    for m in bench["per_layer"]:
        assert core.reader_file(m["name"]).is_file(), m["name"]

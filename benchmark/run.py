"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/`
and the program, `demucs_tpu_torch/`. The cell (`workloads` in
BENCHMARK.json) names a configuration and a traffic mix; the mix's file
names its driver (`benchmark/drivers/<driver>.py`), which builds the
program from the seed, warms the cell's shapes, runs the window and
keeps what the window produced. The program's state is then freed, the
reference checks the kept outputs, and the last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, the cell's metrics
(with `--trace 0` its end-to-end metrics, with `--trace 1` its per-layer
ones, read from a profiled stretch of the window), `device`, with
`--trace 1` the `breakdown`, and last `checks`, each compared number
beside its limit, which also close standard error.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), without the program beside it, and when
a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the caches of the program's kernels live inside the checkout, at fixed paths
CACHE = ROOT / ".bench_cache"


def _fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def execute(entry: dict, cfg: dict, mix: dict, limits: dict, bench: dict, seed: int,
            seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell `entry` -> the result object (printed by main)."""
    import torch

    from benchmark.harness import core

    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    run = core.Run(workload=entry["name"], seed=seed, seconds=seconds, trace=trace,
                   device=device, cfg=cfg, traffic=mix)
    kept = driver.measure(run, t_start)
    found = core.forbidden_loaded()
    if found:
        _fail(5, "modules of JAX or of the JAX package are loaded: " + ", ".join(found))
    t_check = time.perf_counter()
    run.checks = driver.check(run, kept)
    del kept
    print(f"portbench: window {run.window_s:.2f} s, check {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    found = core.forbidden_loaded()
    if found:
        _fail(5, "modules of JAX or of the JAX package are loaded: " + ", ".join(found))

    if trace:
        metrics = {}
        for m in core.layer_metrics(bench, entry["name"]):
            value = core.read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in core.e2e_metrics(bench, entry["name"])}
    # an answer that never came reads inf, written as 1e300 to keep the line JSON
    checks = {k: {"value": v if math.isfinite(v) else 1e300, "limit": limits[k]}
              for k, v in run.checks.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.summary is not None:
        dev.update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
        result["breakdown"] = {"device_ops": run.summary.device_ops,
                               "idle_gaps": run.summary.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "demucs_tpu_torch" / "__init__.py").is_file():
        _fail(4, f"the program (demucs_tpu_torch/) is not in {ROOT}")
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"

    from benchmark.harness import core

    bench = core.spec()
    entry = core.workload_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        _fail(3, f"{entry['chips']} CUDA device(s) needed, "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    cfg = core.load_json(core.config_file(bench, entry["config"]))
    mix = core.load_json(core.traffic_file(entry["traffic"]))
    limits = core.load_json(core.limits_file(entry["name"]))
    result = execute(entry, cfg, mix, limits, bench, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

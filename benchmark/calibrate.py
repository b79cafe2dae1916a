"""The readings that a cell's limits are set from, on the chip.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 ... [--seconds 4]

For each seed, in one process: the cell's own set-up and a short window
at its own load (`--seconds`), then the compared numbers of the program
against the reference (`program`), of the control, the reference
computed with TF32 on in the program's place (`control`), and for a
training cell of the planted fault that leaves half of each batch out
(`half_batch`, in the reference put in the program's place). One JSON
line per seed. The benchmark's own runs never run this.

A limit lies above the largest `program` reading over a dozen seeds or
more and below the smallest `control` (or fault) reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, device=None) -> dict:
    """The `program`, `control` (and for training `half_batch`) numbers of
    one seed."""
    import importlib

    import torch

    from benchmark.drivers.common import ReferenceCache
    from benchmark.harness import core

    bench = core.spec()
    entry = core.workload_entry(bench, workload)
    mix = core.load_json(core.traffic_file(entry["traffic"]))
    run = core.Run(workload=workload, seed=seed, seconds=seconds, trace=False,
                   device=device or torch.device("cuda", 0),
                   cfg=core.load_json(core.config_file(bench, entry["config"])),
                   traffic=mix)
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    kept = driver.measure(run, time.perf_counter())
    cache = ReferenceCache(run)
    out = {"seed": seed, "program": driver.check(run, kept, cache),
           "control": driver.control(run, kept, cache), "attempted": run.attempted,
           "e2e": run.e2e}
    if mix["driver"] == "train":
        from benchmark.reference import train_ref

        out["half_batch"] = train_ref.gaps(
            driver.reference_steps(run, kept, drop_half=True), kept["reference"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Sets of runs of one cell at the same seeds, and each end-to-end
metric's spread in each set: the readings a bound is set from.

    python3 benchmark/sets.py --workload <name> --seeds 11 12 13 14 15 16 \
        [--sets 2] [--trace-seeds 90] [--seconds 51] [--out runs.jsonl]

Every run is `benchmark/run.py` in a process of its own, one after
another, so one process uses the card at a time. The traced runs
(`--trace-seeds`) come first: in a fresh checkout the first run builds
the program's kernels, and its set-up is then kept out of the sets.
Each set runs every seed once, in the order given. Each run's result
line is printed (and appended to `--out`) as {"set", "seed", "rc", "r"},
with `r` the result object, or null where the run printed none; its
lines of standard error that start with "portbench:" or "check" follow
on standard error. The summary, last, gives for each set and metric the
median and the spread, the interquartile range of
`statistics.quantiles(values, n=4)` over the median, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    """Interquartile range over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def card() -> str:
    if shutil.which("nvidia-smi") is None:
        return "unknown"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def one_run(workload: str, seed: int, seconds: float, trace: bool) -> tuple[int, dict | None]:
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                           "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(int(trace))],
                          cwd=ROOT, capture_output=True, text=True)
    for line in proc.stderr.splitlines():
        if line.startswith(("portbench:", "check")):
            print(f"  [{seed}] {line}", file=sys.stderr)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    if result is None:
        print(proc.stderr[-4000:], file=sys.stderr)
    return proc.returncode, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    plan = [("trace", s, True) for s in args.trace_seeds]
    plan += [(chr(ord("A") + k), s, False) for k in range(args.sets) for s in args.seeds]
    values: dict = {}
    ok = True
    for name, seed, trace in plan:
        rc, result = one_run(args.workload, seed, args.seconds, trace)
        line = json.dumps({"set": name, "seed": seed, "rc": rc, "r": result})
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
        ok = ok and result is not None and result["correct"]
        if result is not None and not trace:
            for metric, m in result["metrics"].items():
                values.setdefault(name, {}).setdefault(metric, []).append(m["value"])
    summary = {"workload": args.workload, "card": card(), "all_correct": ok,
               "sets": {name: {metric: {"median": statistics.median(v),
                                        "spread": spread(v) if len(v) >= 2 else None}
                               for metric, v in metrics.items()}
                        for name, metrics in values.items()}}
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

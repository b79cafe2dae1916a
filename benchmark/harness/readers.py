"""What the per-layer readers (`benchmark/metrics/<metric>.py`) share.

Each returns None where the run holds nothing to read (no traced
stretch, no launch of the kernel, no device time), and never 0 for a
share of a roofline or of a peak.
"""

from __future__ import annotations

import sys

from ..reference import bounds
from .core import Run


def mfu(run: Run) -> float | None:
    """The model's operations (`counters["operations"]`, counted on the
    reference from the shapes) over the seconds they took
    (`counters["operations_s"]`: the window, less a profiled stretch
    where the driver can leave it out) x PEAK_FLOPS, in %."""
    ops, secs = run.counters.get("operations"), run.counters.get("operations_s")
    if run.device.type != "cuda" or not ops or not secs:
        return None
    return 100.0 * ops / (secs * bounds.PEAK_FLOPS)


def device_idle(run: Run) -> float | None:
    """The share of the traced stretch in which no kernel, copy or fill
    ran on the device, in %."""
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def roofline(run: Run, op: str) -> float | None:
    """A kernel's share of its roofline over the traced stretch, in %: the
    summed least time of its calls (`reference.bounds`, from each call's
    input shapes) over the summed device time of the CUDA kernels it
    launches. Says on standard error which bound applies."""
    s = run.summary
    if s is None or not s.op_shapes.get(op):
        return None
    count, fragments = bounds.KERNELS[op]
    least = {"operations": 0.0, "bytes": 0.0}
    for dims in s.op_shapes[op]:
        t, by = bounds.least_seconds(*count(*dims))
        least[by] += t
    device = sum(t for name, t in s.kernel_s.items() if any(f in name for f in fragments))
    if device <= 0:
        return None
    total = least["operations"] + least["bytes"]
    by = max(least, key=least.get)
    print(f"portbench: {op}: {len(s.op_shapes[op])} calls, least {total:.6f} s "
          f"({by} bound {100 * least[by] / total:.1f}% of it) over {device:.6f} s of "
          "device time", file=sys.stderr)
    return 100.0 * total / device

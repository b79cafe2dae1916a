"""The traced stretches of a `--trace 1` run and what is read from them.

`Stretch` profiles a steady part of the window with `torch.profiler`,
fenced by a device synchronisation at both ends so that every kernel
launched inside it also runs inside it; its length is taken on the host
clock between the fences. With `shapes` it records host activity and the
input shapes of every op: what the rooflines count, and the host spans
that name the idle gaps. Recording every host op slows a host-bound path
about twofold, so the busy share is read from a second stretch that
records device activity alone. `read()`, called as soon as a stretch
has ended (a profile's events do not survive the next profile), writes
the Chrome trace into the temporary directory, reads it and deletes it. `Summary` holds what the
per-layer readers take:

  * `window_s`: the stretch's length, `busy_s`: the time in which some
    kernel, copy or fill ran on the device (the union over streams);
  * `kernel_s`: device seconds by kernel name;
  * `op_shapes`: the input shapes of each call of the program's custom
    ops (`demucs_tpu_torch::<op>`), for the roofline counts;
  * `device_ops` and `idle_gaps`: the contract's breakdown, the ten
    device operations that took most time and the ten longest idle gaps,
    each named by the innermost host span open at the gap's middle.

`merged(shapes, timing)` joins the two stretches' summaries. `span(name)`
marks a host span in the trace (a `record_function`); it costs nothing
outside a stretch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
OP_PREFIX = "demucs_tpu_torch::"
STRETCH = "bench.stretch"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict
    op_shapes: dict
    device_ops: list
    idle_gaps: list


def span(name: str):
    return torch.profiler.record_function(name)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list[dict], window_s: float) -> Summary:
    """The `Summary` of a Chrome trace's events (times in microseconds) of
    a stretch `window_s` long."""
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in x if e.get("cat") in DEVICE_CATS]
    stretch = next((e for e in x if e.get("name") == STRETCH), None)
    if stretch is not None:
        t0, t1 = stretch["ts"], stretch["ts"] + stretch["dur"]
    else:
        t0 = min((e["ts"] for e in device), default=0.0)
        t1 = max((e["ts"] + e["dur"] for e in device), default=0.0)
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device
                  if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    kernel_s: dict = collections.Counter()
    for e in device:
        kernel_s[e["name"]] += e["dur"] / 1e6
    op_shapes = collections.defaultdict(list)
    for e in x:
        if e.get("cat") == "cpu_op" and e["name"].startswith(OP_PREFIX):
            op_shapes[e["name"][len(OP_PREFIX):]].append(e.get("args", {}).get("Input Dims"))
    host = [e for e in x if e.get("cat") in HOST_CATS and e.get("name") != STRETCH]
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    longest = sorted(((e - s, s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s),
                     reverse=True)[:10]
    gaps = []
    for length, s, e in longest:
        mid = (s + e) / 2
        open_ = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        label = max(open_, key=lambda h: h["ts"])["name"] if open_ else "host, no torch span"
        gaps.append([label[:120], length / 1e6])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=window_s,
                   busy_s=sum(e - s for s, e in busy) / 1e6,
                   kernel_s=dict(kernel_s), op_shapes=dict(op_shapes),
                   device_ops=[[k[:160], v] for k, v in top], idle_gaps=gaps)


def merged(shapes: Summary, timing: Summary) -> Summary:
    """The shapes stretch's counts and gaps with the timing stretch's
    busy share and device operations."""
    return dataclasses.replace(shapes, window_s=timing.window_s, busy_s=timing.busy_s,
                               device_ops=timing.device_ops)


class Stretch:
    """with Stretch(enabled, device, shapes): ... profiles the block when
    enabled; `read()` then returns its `Summary` (None when not
    enabled)."""

    def __init__(self, enabled: bool, device, shapes: bool = True):
        self.enabled = enabled
        self.shapes = shapes
        self.cuda = torch.device(device).type == "cuda"
        self._prof = None
        self.window_s = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._sync()
            activities = [ProfilerActivity.CUDA] if self.cuda else []
            if self.shapes or not self.cuda:
                activities.append(ProfilerActivity.CPU)
            self._prof = profile(activities=activities, record_shapes=self.shapes)
            self._prof.__enter__()
            self._span = span(STRETCH)
            self._span.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._sync()
            self.window_s = time.perf_counter() - self._t0
            self._span.__exit__(None, None, None)
            self._prof.__exit__(*exc)
        return False

    def read(self) -> Summary | None:
        if self._prof is None or self.window_s is None:
            return None
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return summarize(json.loads(Path(path).read_text())["traceEvents"], self.window_s)
        finally:
            Path(path).unlink(missing_ok=True)
            self._prof = None


@contextlib.contextmanager
def spanned(obj, *names: str):
    """Within the block, each method `name` of the instance `obj` runs
    inside a host span `bench.<name>` (used in traced runs only, to name
    the idle gaps)."""
    saved = {n: getattr(obj, n) for n in names}
    for n, fn in saved.items():
        def wrapped(*a, _fn=fn, _n=n, **k):
            with span(f"bench.{_n}"):
                return _fn(*a, **k)
        setattr(obj, n, wrapped)
    try:
        yield
    finally:
        for n in names:
            delattr(obj, n)

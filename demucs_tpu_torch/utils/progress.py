"""Progress reporting: a callable (fraction: float, message: str) -> None,
API-compatible with `demucs_tpu/utils/progress.py`.

Two granularities:
  * per-device-batch (default): the pipeline reports after each batched
    segment call;
  * intra-segment stages (26 marks per v4 segment, 22 per v3 segment):
    the model graphs call `report_stage` at the JAX package's positions.
    A mark does nothing unless it is enabled by `stage_tracing()` and a
    sink is installed by `stage_sink()`.

Where a mark is reported. PyTorch launches kernels eagerly and returns
before the device has run them, so a host callback at the mark would
fire at launch time. On a CUDA sink each enabled mark therefore records
a CUDA event on the current stream; leaving `stage_sink` waits for the
last of them (the counterpart of `jax.effects_barrier()`) and emits the
marks in order, each with its stage's device time: the elapsed time
from the previous mark's event (the first stage's from an event
recorded as the sink opened). `TimedProgress` reads that time through
`stage_device_seconds()` while the mark is being emitted. On a CPU sink
a mark is emitted at once and has no device time.

The switch and the sink are process-wide, as in the JAX package: one
stage-reporting call at a time.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable

import torch

ProgressCallback = Callable[[float, str], None]

# run-time switch: marks are no-ops unless this is True
_TRACE_STAGES = False
# the installed sink: (callback, CUDA device or None, pending marks)
_STAGE_SINK: tuple | None = None
# device seconds of the stage being emitted right now (None outside an
# emission, and for marks without a device time)
_STAGE_DEVICE_S: float | None = None


@contextlib.contextmanager
def stage_tracing():
    """Enable intra-segment stage marks for model calls inside."""
    global _TRACE_STAGES
    prev = _TRACE_STAGES
    _TRACE_STAGES = True
    try:
        yield
    finally:
        _TRACE_STAGES = prev


@contextlib.contextmanager
def stage_sink(cb: ProgressCallback, device: str | torch.device | None = None):
    """Route stage marks made inside to `cb`, in order, one call at a time.

    With a CUDA `device`, the marks are events on its current stream and
    reach `cb` when the block exits, after the device has passed the last
    of them; otherwise each reaches `cb` as it is made."""
    global _STAGE_SINK
    cuda = torch.device(device) if device is not None else None
    if cuda is not None and cuda.type != "cuda":
        cuda = None
    pending: list = []
    if cuda is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(cuda))
        pending.append((start, None, None))
    prev = _STAGE_SINK
    _STAGE_SINK = (cb, cuda, pending)
    try:
        yield
    finally:
        _STAGE_SINK = prev
    if len(pending) > 1:
        pending[-1][0].synchronize()
        for (before, _, _), (event, fraction, message) in zip(pending, pending[1:]):
            _emit(cb, fraction, message, before.elapsed_time(event) / 1e3)


def _emit(cb: ProgressCallback, fraction: float, message: str,
          device_s: float | None) -> None:
    global _STAGE_DEVICE_S
    _STAGE_DEVICE_S = device_s
    try:
        cb(fraction, message)
    finally:
        _STAGE_DEVICE_S = None


def stage_device_seconds() -> float | None:
    """The device time of the stage mark being emitted now, in seconds;
    None for a mark without one (CPU) and outside a mark's emission."""
    return _STAGE_DEVICE_S


def report_stage(fraction: float, message: str) -> None:
    """Stage mark for model graphs: a no-op unless enabled. Enabled, it
    records one CUDA event (a CUDA sink) or calls the sink (otherwise);
    it never waits for the device and launches no kernel."""
    if not _TRACE_STAGES:
        return
    sink = _STAGE_SINK
    if sink is None:
        return
    cb, cuda, pending = sink
    if cuda is None:
        _emit(cb, fraction, message, None)
        return
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(cuda))
    pending.append((event, fraction, message))


def null_progress(fraction: float, message: str) -> None:
    pass


def print_progress(fraction: float, message: str) -> None:
    print(f"[{fraction * 100:5.1f}%] {message}", file=sys.stderr)


class TimedProgress:
    """Progress callback that also records per-stage wall times, and the
    device time of each stage mark that has one (`device_s`, beside
    `events`)."""

    def __init__(self, inner: ProgressCallback = null_progress):
        self.inner = inner
        self.events: list[tuple[float, float, str]] = []
        self.device_s: list[float | None] = []
        self._t0 = time.monotonic()

    def __call__(self, fraction: float, message: str) -> None:
        self.events.append((time.monotonic() - self._t0, fraction, message))
        self.device_s.append(stage_device_seconds())
        self.inner(fraction, message)

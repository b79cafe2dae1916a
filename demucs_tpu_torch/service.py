"""Cross-request batching through one device-feeder thread: the port of
`demucs_tpu/service.py`.

One feeder thread owns the device. Concurrent requests submit groups of
segments, which it assembles into shared `batch_size` device calls
(segments from many tracks fill one batch, the server-side counterpart
of `pipeline.Separator.separate_many`), and whole-track fused passes
run as exclusive items on the same queue, in FIFO order with the
batches. A streaming session so never holds the device between its
chunks: each push is more segments in the shared stream.

On CUDA the thread is where a `pipeline.Separator`'s one-call-at-a-time
state lives: the pinned staging ring of `_place`, `_run_model` and the
side copy stream are touched only there. The current device, the
current stream and `torch.inference_mode` are per thread, so the
feeder thread sets its device and enters inference mode itself. The
callers' side of a request (`Separator._prepare` and `_finish`) is numpy
and runs on their own threads.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable

import numpy as np
import torch

from .utils.progress import ProgressCallback, null_progress


class _SegItem:
    """A contiguous group of segments from one request."""

    __slots__ = ("segs", "fut", "cursor", "parts", "delivered", "failed")

    def __init__(self, segs: np.ndarray, fut: Future):
        self.segs = segs
        self.fut = fut
        self.cursor = 0        # segments scheduled into batches
        self.delivered = 0     # segments whose outputs have landed
        self.parts: list[np.ndarray] = []
        self.failed = False

    @property
    def n(self) -> int:
        return self.segs.shape[0]


class _CallItem:
    """An exclusive device call (e.g. a fused whole-track pass)."""

    __slots__ = ("fn", "fut")

    def __init__(self, fn: Callable, fut: Future):
        self.fn = fn
        self.fut = fut


class DeviceFeeder:
    """The one thread that drives the device, with cross-request segment
    batching.

    separator: a `pipeline.Separator` whose batched device step the feeder
    drives (`separator.options.batch_size` segments a call, the last
    batch padded with zeros to that size). `fill_wait_s`: how long a
    partial batch waits for segments of concurrent requests before it
    runs padded (3 ms: little next to a device step, long enough for a
    concurrent handler thread to enqueue). `stats` counts the device
    calls, the segments, the padding and the exclusive calls.
    """

    def __init__(self, separator, fill_wait_s: float = 0.003):
        self._sep = separator
        self._B = max(1, separator.options.batch_size)
        self._fill_wait = fill_wait_s
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._closed = False
        self.stats = {"device_calls": 0, "segments": 0, "padded": 0,
                      "exclusive_calls": 0}
        # the separator's card ("cuda" alone: the creating thread's current one)
        device = separator.device
        self._cuda_index = None if device.type != "cuda" else (
            torch.cuda.current_device() if device.index is None else device.index)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-feeder")
        self._thread.start()

    # --- submission (thread-safe) --------------------------------------

    def _enqueue(self, item) -> None:
        with self._cv:
            if self._closed or not self._thread.is_alive():
                raise RuntimeError("DeviceFeeder is closed or dead")
            self._items.append(item)
            self._cv.notify()

    def submit_segments(self, segs: np.ndarray) -> Future:
        """(n, C, seg) segments -> Future of their (n, S, C, seg) f32 stems
        (fetched, an int16 transfer already decoded)."""
        segs = np.asarray(segs)
        fut: Future = Future()
        if segs.shape[0] == 0:
            fut.set_result(np.zeros((0,), np.float32))
            return fut
        self._enqueue(_SegItem(segs, fut))
        return fut

    def run_exclusive(self, fn: Callable) -> Future:
        """Queue fn() as an exclusive device call (fused passes, warmup); it
        runs on the feeder thread in FIFO order with the segment batches."""
        fut: Future = Future()
        self._enqueue(_CallItem(fn, fut))
        return fut

    def separate(self, audio: np.ndarray,
                 progress: ProgressCallback = null_progress) -> np.ndarray:
        """A whole track through the shared batches: (C, N) -> (S, C, N).
        Thread-safe: the host side (prepare, finish) runs on the caller's
        thread, and only the device steps go to the feeder, merged with
        other requests' segments."""
        batch, state = self._sep._prepare(audio, progress)
        out = self.submit_segments(batch).result()
        progress(1.0, f"segments {batch.shape[0]}/{batch.shape[0]}")
        return self._sep._finish(out, state)

    def close(self, timeout: float = 30.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    # --- feeder loop ----------------------------------------------------

    @staticmethod
    def _resolve(fut: Future, result=None, exc: BaseException | None = None) -> None:
        """Settle fut, unless its caller has cancelled it."""
        try:
            if exc is None:
                fut.set_result(result)
            else:
                fut.set_exception(exc)
        except InvalidStateError:
            pass

    def _fail(self, items, exc: BaseException) -> None:
        for it in items:
            it.failed = True
            self._resolve(it.fut, exc=exc)

    def _run(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.inference_mode():
            self._loop()

    def _next_batch(self) -> list[tuple[_SegItem, int, int]]:
        """Drain segment items in FIFO order into one batch of up to B,
        waiting up to fill_wait for concurrent producers to top off a
        partial batch; an exclusive call ends the batch (strict FIFO keeps
        fused calls from starving). -> [(item, first segment, count)]."""
        parts: list[tuple[_SegItem, int, int]] = []
        fill = 0
        deadline = time.monotonic() + self._fill_wait
        while fill < self._B:
            with self._cv:
                nxt = self._items[0] if self._items else None
                if isinstance(nxt, _SegItem):
                    take = min(self._B - fill, nxt.n - nxt.cursor)
                    parts.append((nxt, nxt.cursor, take))
                    nxt.cursor += take
                    fill += take
                    if nxt.cursor == nxt.n:
                        self._items.popleft()
                    continue
                if nxt is not None or self._closed:
                    break  # exclusive call next, or shutting down
                if time.monotonic() >= deadline:
                    break
                self._cv.wait(timeout=0.001)
        return parts

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._items and not self._closed:
                    self._cv.wait()
                if not self._items and self._closed:
                    return
                head = self._items[0]
                if isinstance(head, _CallItem):
                    self._items.popleft()
            if isinstance(head, _CallItem):
                self.stats["exclusive_calls"] += 1
                try:
                    self._resolve(head.fut, head.fn())
                except Exception as e:
                    self._resolve(head.fut, exc=e)
                continue

            parts = self._next_batch()
            if not parts:
                continue
            batch = np.concatenate([it.segs[c:c + k] for it, c, k in parts])
            fill = batch.shape[0]
            pad = self._B - fill
            if pad:
                batch = np.concatenate(
                    [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
            self.stats["device_calls"] += 1
            self.stats["segments"] += fill
            self.stats["padded"] += pad
            try:
                out = self._sep._call_device(self._sep._place(batch))
            except Exception as e:
                # a failed batch fails only its own items
                affected = {id(it): it for it, _, _ in parts}
                with self._cv:
                    for it in affected.values():
                        if it in self._items:
                            self._items.remove(it)
                self._fail(affected.values(), e)
                continue

            off = 0
            for it, _, k in parts:
                it.parts.append(out[off:off + k])
                it.delivered += k
                off += k
                if it.delivered == it.n and not it.failed:
                    self._resolve(it.fut, np.concatenate(it.parts)
                                  if len(it.parts) > 1 else it.parts[0])

"""Streaming (chunked, stateful) separation: the port of
`demucs_tpu/streaming.py`.

Audio is fed in chunks of any size; finalized stems come back as soon as
no later segment can still add to them. The segment grid, the triangular
overlap-add and the tail padding are those of the offline path
(`pipeline.Separator`): with the same normalization statistics and no
shift, the streamed output equals the offline output up to f32 rounding.
The latency is one segment plus one stride of audio.

Against the offline path:
  * the track's mean and std need the whole track; here they run over
    the first `stats_seconds` of audio and then freeze (or pass fixed
    `stats=(mean, std)`);
  * no shift trick (it needs the whole track).

The host side (buffers, statistics, the f64 accumulators) is numpy, as
in the JAX package. The device calls go through `Separator`'s batched
path: pinned uploads and downloads on CUDA, `max_batch` segments a call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import config as C
from .pipeline import ApplyOptions, Separator, triangle_weight
from .utils.progress import null_progress


class StreamingSeparator:
    """Stateful chunked separation.

    `model` maps (B, C, segment) to (B, S, C, segment): one model, or a
    `models.BagOfModels`, built in the dtype it should run in (the CLI's
    `--bf16` casts the weights before the build).

    push(chunk (C, n)) -> (S, C, m): the newly finalized stems (m may be
    0 while the window fills).
    flush() -> (S, C, rest): pads and drains the tail; resets the state.
    """

    def __init__(self, model: torch.nn.Module | None, num_sources: int,
                 segment_samples: int = C.SEGMENT_SAMPLES,
                 overlap: float = C.OVERLAP,
                 transition_power: float = C.TRANSITION_POWER,
                 stats: tuple[float, float] | None = None,
                 stats_seconds: float = 10.0,
                 max_batch: int = 8,
                 run_batch: Callable | None = None,
                 device: str | torch.device = "cuda"):
        """max_batch: ready segments per device call; a push spanning
        several strides (and every flush) runs its segments in groups of
        max_batch instead of one call each.
        run_batch: optional (n, C, seg) f32 -> (n, S, C, seg) f32 device
        hook. When set, `model` and `device` are unused and the instance
        holds no device state, so that many streams can share one feeder
        of batched device calls."""
        self.num_sources = num_sources
        self.segment = int(segment_samples)
        self.stride = int((1 - overlap) * self.segment)
        self.max_batch = int(max_batch)
        self._run_batch = run_batch
        self._sep = None
        if run_batch is None:
            # the JAX class pads each call to a power-of-two batch, which
            # bounds XLA's compiled programs; eager PyTorch needs no such
            # bound, and the padding would only add work, so exactly the
            # ready segments run, max_batch at a time
            self._sep = Separator(model, num_sources, ApplyOptions(batch_size=self.max_batch),
                                  device)
        self._weight = triangle_weight(self.segment, transition_power)
        self._stats = stats
        self._stats_n_target = int(stats_seconds * C.SAMPLE_RATE)
        self.reset()

    @property
    def device(self) -> torch.device | None:
        return None if self._sep is None else self._sep.device

    def reset(self) -> None:
        self._in: np.ndarray | None = None     # raw audio buffer (C, n)
        self._consumed = 0                     # in-buffer trim offset
        self._next_off = 0                     # next segment offset (global)
        self._emitted = 0                      # samples emitted (global)
        self._acc: np.ndarray | None = None    # weighted stem accumulator
        self._wsum: np.ndarray | None = None   # weight accumulator
        self._acc_start = 0                    # global index of acc[..., 0]
        self._stat_sum = 0.0
        self._stat_sumsq = 0.0
        self._stat_n = 0

    # --- statistics -----------------------------------------------------

    def _update_stats(self, chunk: np.ndarray) -> None:
        if self._stats is not None or self._stat_n >= self._stats_n_target:
            return
        mono = chunk.mean(0)
        self._stat_sum += float(mono.sum())
        self._stat_sumsq += float(np.square(mono, dtype=np.float64).sum())
        self._stat_n += mono.shape[-1]

    def _mean_std(self) -> tuple[float, float]:
        if self._stats is not None:
            return self._stats
        n = max(self._stat_n, 2)
        mean = self._stat_sum / n
        var = max(self._stat_sumsq / n - mean * mean, 0.0) * n / (n - 1)
        return mean, max(np.sqrt(var), 1e-8)

    # --- core -----------------------------------------------------------

    def _total_buffered(self) -> int:
        return 0 if self._in is None else self._consumed + self._in.shape[-1]

    def _run_segments(self, segs: list[tuple[np.ndarray, int]]) -> np.ndarray:
        """[((C, clen) raw audio, left_pad), ...] -> (n, S, C, segment)
        denormalized stems, max_batch segments per device call.

        Short tails are zero-padded after normalization, as the offline
        path normalizes the track first and pads the segment batch with
        zeros (split_into_segments); denormalization commutes through the
        weighted overlap-add because it is affine and the weights are
        normalized by their own sum."""
        mean, std = self._mean_std()
        n = len(segs)
        Cch = segs[0][0].shape[0]
        batch = np.zeros((n, Cch, self.segment), np.float32)
        for i, (raw, left) in enumerate(segs):
            x = (raw - mean) / std
            batch[i, :, left:left + x.shape[-1]] = x
        if self._run_batch is not None:
            out = np.asarray(self._run_batch(batch)).astype(np.float32)
        else:
            out = self._sep._run_batched(batch, null_progress)
        return out * std + mean

    def _ensure_acc(self, upto: int) -> None:
        S, Cch = self.num_sources, self._in.shape[0]
        need = upto - self._acc_start
        if self._acc is None:
            self._acc = np.zeros((S, Cch, need), np.float64)
            self._wsum = np.zeros(need, np.float64)
        elif self._acc.shape[-1] < need:
            grow = need - self._acc.shape[-1]
            self._acc = np.concatenate(
                [self._acc, np.zeros((S, Cch, grow), np.float64)], -1)
            self._wsum = np.concatenate([self._wsum, np.zeros(grow)], -1)

    def _add_segment(self, off: int, stems: np.ndarray, clen: int,
                     left: int) -> None:
        self._ensure_acc(off + clen)
        a = off - self._acc_start
        w = self._weight[:clen]
        self._acc[:, :, a:a + clen] += w * stems[:, :, left:left + clen]
        self._wsum[a:a + clen] += w

    def _emit(self, upto: int) -> np.ndarray:
        """Return the finalized stems in [self._emitted, upto)."""
        if upto <= self._emitted:
            return np.zeros((self.num_sources,
                             0 if self._in is None else self._in.shape[0],
                             0), np.float32)
        a = self._emitted - self._acc_start
        b = upto - self._acc_start
        out = (self._acc[:, :, a:b] /
               np.maximum(self._wsum[a:b], 1e-12)).astype(np.float32)
        # drop the emitted prefix from the accumulators
        self._acc = self._acc[:, :, b:]
        self._wsum = self._wsum[b:]
        self._acc_start = upto
        self._emitted = upto
        return out

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (C, n) audio; returns the newly finalized (S, C, m) stems."""
        chunk = np.atleast_2d(np.asarray(chunk, np.float32))
        self._update_stats(chunk)
        if self._in is None:
            self._in = chunk
        else:
            self._in = np.concatenate([self._in, chunk], -1)
        total = self._total_buffered()
        # every ready segment first, then their device calls, then the
        # overlap-add
        ready: list[tuple[int, np.ndarray]] = []
        while self._next_off + self.segment <= total:
            local = self._next_off - self._consumed
            ready.append((self._next_off,
                          self._in[:, local:local + self.segment]))
            self._next_off += self.stride
        if ready:
            stems = self._run_segments([(seg, 0) for _, seg in ready])
            for (off, _), out in zip(ready, stems):
                self._add_segment(off, out, self.segment, 0)
            # audio before the next segment's start is never read again
            drop = self._next_off - self._consumed
            if drop > 0:
                self._in = self._in[:, drop:]
                self._consumed = self._next_off
        # every sample before the next unprocessed offset is final
        return self._emit(min(self._next_off, total))

    def flush(self) -> np.ndarray:
        """Process the padded tail (the offline split_into_segments
        padding), emit everything left, reset."""
        total = self._total_buffered()
        if self._in is None or total == 0:
            return np.zeros((self.num_sources, 0, 0), np.float32)
        tails: list[tuple[int, np.ndarray, int, int]] = []
        while self._next_off < total:
            local = self._next_off - self._consumed
            tail = self._in[:, local:local + self.segment]
            clen = tail.shape[-1]
            tails.append((self._next_off, tail, clen,
                          (self.segment - clen) // 2))
            self._next_off += self.stride
        if tails:
            stems = self._run_segments(
                [(tail, left) for _, tail, _, left in tails])
            for (off, _, clen, left), out in zip(tails, stems):
                self._add_segment(off, out, clen, left)
        out = self._emit(total)
        self.reset()
        return out

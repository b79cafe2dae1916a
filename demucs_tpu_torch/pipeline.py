"""Full-track inference orchestration: normalize / shift / split / batch /
overlap-add.

The port of the batched path of `demucs_tpu/pipeline.py`. Segments of a
track go to the device in batches of `batch_size`; the overlap-add
bookkeeping stays on the host in numpy. Conventions preserved exactly:

  * 7.8 s segments, 25% overlap (stride = 0.75 * segment)
  * triangular transition weights ** TRANSITION_POWER
  * random shift in [0, 0.5 s) with symmetric zero padding; the
    reference pins offset=1337 samples for SDR comparisons — pass
    shift_offset=1337 for parity
  * track-level mono-reference mean/std normalization

PyTorch runs eagerly, so the last batch is not padded to `batch_size`
as the JAX package's fixed-shape programs need.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import config as C
from .utils.device import resolve_device
from .utils.progress import ProgressCallback, null_progress


@dataclasses.dataclass
class ApplyOptions:
    segment_samples: int = C.SEGMENT_SAMPLES
    overlap: float = C.OVERLAP
    transition_power: float = C.TRANSITION_POWER
    max_shift_secs: float = C.MAX_SHIFT_SECS
    shift_offset: int | None = None   # None => derived from seed
    shift_seed: int = 1337
    batch_size: int = 8               # segments per device call
    dtype: np.dtype = np.float32

    def with_segment(self, segment_samples: int | None) -> "ApplyOptions":
        """Copy with a shorter segment; the shift pad must stay well
        inside it."""
        if not segment_samples:
            return self
        return dataclasses.replace(
            self,
            segment_samples=segment_samples,
            max_shift_secs=min(self.max_shift_secs,
                               segment_samples / C.SAMPLE_RATE / 4))


def triangle_weight(segment: int, power: float = 1.0) -> np.ndarray:
    """Split-inference transition weights."""
    half = segment // 2
    w = np.concatenate([
        np.linspace(1, half, half, dtype=np.float64),
        np.linspace(1, half, half, dtype=np.float64)[::-1],
    ])
    if segment % 2:  # odd segments: center sample gets max weight
        w = np.concatenate([w[:half], [half], w[half:]])
    w = w / w.max()
    return (w ** power).astype(np.float32)


def split_into_segments(audio: np.ndarray, segment: int, stride: int):
    """(C, N) -> (num_segments, C, segment) with symmetric zero padding of
    short tails.

    Returns (batch, per-segment (offset, chunk_length, left_pad)).
    """
    C_, N = audio.shape
    offsets = list(range(0, N, stride))
    batch = np.zeros((len(offsets), C_, segment), audio.dtype)
    meta = []
    for i, off in enumerate(offsets):
        chunk = audio[:, off:off + segment]
        clen = chunk.shape[-1]
        left = (segment - clen) // 2
        batch[i, :, left:left + clen] = chunk
        meta.append((off, clen, left))
    return batch, meta


def overlap_add(chunks: np.ndarray, meta, length: int, segment: int,
                weight: np.ndarray) -> np.ndarray:
    """Weighted recombination.

    chunks: (num_segments, S, C, segment) — still symmetric-padded.
    """
    S, Cch = chunks.shape[1], chunks.shape[2]
    out = np.zeros((S, Cch, length), np.float64)
    sum_w = np.zeros(length, np.float64)
    for (off, clen, left), chunk in zip(meta, chunks):
        trimmed = chunk[:, :, left:left + clen]
        w = weight[:clen]
        end = min(off + clen, length)
        n = end - off
        out[:, :, off:end] += w[None, None, :n] * trimmed[:, :, :n]
        sum_w[off:end] += w[:n]
    return (out / sum_w[None, None, :]).astype(np.float32)


class Separator:
    """Batched track separator for one model.

    `model` maps a (B, C, L) float32 tensor to (B, S, C, L); it is moved
    to `device` ("cuda" unless the caller asks for "cpu"; a CUDA request
    without a GPU raises) and run under `torch.inference_mode()`.
    """

    def __init__(self, model: torch.nn.Module, num_sources: int,
                 options: ApplyOptions | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.options = options or ApplyOptions()
        self.num_sources = num_sources
        self.model = model.to(self.device).eval()

    def _run_batched(self, batch: np.ndarray,
                     progress: ProgressCallback) -> np.ndarray:
        bs = self.options.batch_size
        n = batch.shape[0]
        n_calls = math.ceil(n / bs)
        outs = []
        with torch.inference_mode():
            for i in range(0, n, bs):
                x = torch.from_numpy(batch[i:i + bs]).to(self.device)
                outs.append(self.model(x).float().cpu().numpy())
                progress(len(outs) / n_calls, f"segments {min(i + bs, n)}/{n}")
        return np.concatenate(outs)

    def _normalize_shift(self, audio: np.ndarray, progress: ProgressCallback):
        """normalize + shift one track -> (shifted, (max_shift, offset,
        N, ref_mean, ref_std))."""
        o = self.options
        N = audio.shape[-1]

        # --- track normalization (mono-reference, unbiased std)
        ref = audio.mean(0)
        ref_mean = ref.mean()
        ref_std = ref.std(ddof=1)
        normalized = (audio - ref_mean) / max(ref_std, 1e-8)

        # --- shift trick
        max_shift = int(o.max_shift_secs * C.SAMPLE_RATE)
        if o.shift_offset is not None:
            offset = o.shift_offset
        elif max_shift == 0:  # max_shift_secs=0 means "no shift"
            offset = 0
        else:
            offset = np.random.default_rng(o.shift_seed).integers(0, max_shift)
        offset = int(offset)
        padded = np.zeros((audio.shape[0], N + 2 * max_shift), o.dtype)
        padded[:, max_shift:max_shift + N] = normalized
        shifted = padded[:, offset:]  # length N + 2*max_shift - offset
        shifted = shifted[:, :N + max_shift - offset]
        progress(0.0, f"apply model w/ shift, offset: {offset}")
        return shifted, (max_shift, offset, N, ref_mean, ref_std)

    def _prepare(self, audio: np.ndarray, progress: ProgressCallback):
        """normalize + shift + split one track -> (segment batch, state)."""
        o = self.options
        shifted, (max_shift, offset, N, ref_mean, ref_std) = \
            self._normalize_shift(audio, progress)
        segment = o.segment_samples
        stride = int((1 - o.overlap) * segment)
        batch, meta = split_into_segments(shifted, segment, stride)
        state = (meta, shifted.shape[-1], max_shift, offset, N,
                 ref_mean, ref_std)
        return batch, state

    def _finish(self, chunk_out: np.ndarray, state) -> np.ndarray:
        """overlap-add + un-shift + denormalize one track."""
        o = self.options
        meta, shifted_len, max_shift, offset, N, ref_mean, ref_std = state
        segment = o.segment_samples
        combined = overlap_add(chunk_out, meta, shifted_len, segment,
                               triangle_weight(segment, o.transition_power))
        out = combined[:, :, max_shift - offset:max_shift - offset + N]
        return out * ref_std + ref_mean

    def __call__(self, audio: np.ndarray,
                 progress: ProgressCallback = null_progress) -> np.ndarray:
        """(C, N) float32 -> (S, C, N) float32."""
        batch, state = self._prepare(audio, progress)
        chunk_out = self._run_batched(batch, progress)
        return self._finish(chunk_out, state)

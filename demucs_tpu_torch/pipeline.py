"""Full-track inference orchestration: normalize / shift / split / batch /
overlap-add.

The port of `demucs_tpu/pipeline.py` (single device). Conventions
preserved exactly:

  * 7.8 s segments, 25% overlap (stride = 0.75 * segment)
  * triangular transition weights ** TRANSITION_POWER
  * random shift in [0, 0.5 s) with symmetric zero padding; the
    reference pins offset=1337 samples for SDR comparisons — pass
    shift_offset=1337 for parity
  * track-level mono-reference mean/std normalization

Two device paths, as in the JAX package:

  * batched (default): segments go to the device in batches of
    `batch_size`, and the overlap-add stays on the host in numpy. Up to
    `pipeline_depth` batches are in flight: batch i+1 is launched before
    batch i is fetched. On CUDA each batch is uploaded from a reused
    pinned staging buffer, and its stems come back on a side stream into
    pinned host memory, so the host waits only for that copy;
  * fused (`fused_track`): one upload and one download per track; the
    split, the model in groups of `fused_sub_batch` segments and the
    weighted overlap-add all run on the device.

`SequentialBagSeparator` runs the fine-tuned bag (`models.BagOfModels`)
through these paths.

`transfer_int16` encodes the stems to int16 on the device before they
are copied to the host. PyTorch runs eagerly, so the last batch is not
padded to `batch_size` as the JAX package's fixed-shape programs need.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import config as C
from .models.bag import BagOfModels
from .utils import profiling
from .utils.device import resolve_device
from .utils.progress import ProgressCallback, null_progress, stage_sink, stage_tracing


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
    # report the model's intra-segment stages (26 per v4 segment, 22 per
    # v3 segment) through the progress callback; the batches then run one
    # at a time. Off by default: the marks cost nothing when off
    fine_progress: bool = False
    # encode the stems to int16 (PCM16_TRANSFER_SCALE) on the device
    # before the device-to-host copy, which halves its bytes; off by
    # default, so that f32 transfers stay bit-exact
    transfer_int16: bool = False
    # batches (fused path: tracks) in flight; each fetch of result i may
    # have up to depth - 1 later ones already launched. 1 = strictly serial
    pipeline_depth: int = 2
    # run each track as one fused device pass: split, model and weighted
    # overlap-add on the device, one upload and one download per track
    fused_track: bool = False
    # how fused_track groups track lengths into plans (`_fused_cache`):
    #   "exact": one plan per segment count;
    #   "geo":   segment counts snapped up a ~1.25x geometric grid, so
    #            log-many plans cover every length (with zero segments
    #            at the tail of a bucket)
    # the result is the same for any true length inside a bucket
    fused_buckets: str = "exact"
    # segments per model call inside the fused pass; None = min(2,
    # batch_size). Transfers are unaffected
    fused_sub_batch: int | None = None

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


# int16 transfer scale: 8.0 of headroom in the normalized track domain
# (the normalized mix has unit std; stems peak at a few sigma), a
# quantization step of 8/32767 = 2.4e-4
PCM16_TRANSFER_SCALE = 32767.0 / 8.0


def encode_int16(y: torch.Tensor) -> torch.Tensor:
    """Stems -> int16 at PCM16_TRANSFER_SCALE: round half to even (as
    numpy and jnp.round do), clip, cast."""
    q = torch.round(y.float() * PCM16_TRANSFER_SCALE)
    return torch.clamp(q, -32768.0, 32767.0).to(torch.int16)


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
    """Track separator for one model.

    `model` maps a (B, C, L) float32 tensor to (B, S, C, L); it is moved
    to `device` ("cuda" unless the caller asks for "cpu"; a CUDA request
    without a GPU raises) and run under `torch.inference_mode()` on the
    device's current stream. One call at a time: the staging buffers and
    the copy stream belong to the instance. Concurrent requests are served
    through a `service.DeviceFeeder`, whose one thread owns the device
    steps (`_place`, `_call_device`; fused passes as exclusive calls) and
    merges the requests' segments into shared batches, while each caller
    runs the numpy-only `_prepare` and `_finish` on its own thread.
    """

    def __init__(self, model: torch.nn.Module, num_sources: int,
                 options: ApplyOptions | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.options = options or ApplyOptions()
        if self.options.fused_track and self.options.fine_progress:
            raise ValueError(
                "fused_track runs the whole track as one device pass; the "
                "intra-segment fine_progress stages cannot be reported per "
                "batch; choose one")
        self.num_sources = num_sources
        self.model = model.to(self.device).eval()
        # each bucket's plan for the fused path, least recently used first
        self._fused_cache: collections.OrderedDict = collections.OrderedDict()
        # LRU cap on the plans (None = unbounded)
        self.fused_cache_limit: int | None = None
        self._cuda = self.device.type == "cuda"
        # the side stream of the device-to-host copies
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        # pinned staging buffers of the uploads, one per batch in flight:
        # (flat buffer, event recorded after its last upload)
        self._staging: list = [None] * max(1, self.options.pipeline_depth)
        self._stage_next = 0

    # --- one device step: place, run, download, fetch ---------------------

    def _place(self, host: np.ndarray) -> torch.Tensor:
        """Upload one host array. On CUDA it is copied into the next pinned
        staging buffer (after that buffer's previous upload has read it)
        and sent with non_blocking=True on the current stream."""
        if not self._cuda:
            return torch.from_numpy(np.ascontiguousarray(host))
        k = self._stage_next
        self._stage_next = (k + 1) % len(self._staging)
        dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
        slot = self._staging[k]
        if slot is not None:
            buf, uploaded = slot
            with profiling.span("device.wait"):
                uploaded.synchronize()
        if slot is None or buf.numel() < host.size or buf.dtype != dtype:
            buf = torch.empty(host.size, dtype=dtype, pin_memory=True)
            profiling.count("staging_allocs")
            profiling.count("staging_bytes", host.nbytes)
        staged = buf[:host.size].view(host.shape)
        staged.numpy()[...] = host
        placed = staged.to(self.device, non_blocking=True)
        uploaded = torch.cuda.Event()
        uploaded.record(torch.cuda.current_stream(self.device))
        self._staging[k] = (buf, uploaded)
        return placed

    def _host_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A host tensor for results: pinned when they come from a GPU."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def _pinned_blocks(self) -> int:
        """The pinned blocks PyTorch's caching host allocator has created
        (each a cudaHostAlloc), 0 off CUDA."""
        return torch.cuda.host_memory_stats().get("num_host_alloc", 0) if self._cuda else 0

    def _out_dtype(self) -> torch.dtype:
        return torch.int16 if self.options.transfer_int16 else torch.float32

    def _run_model(self, placed: torch.Tensor) -> torch.Tensor:
        """The model on one placed batch, on the current (compute) stream,
        its stems encoded to int16 there with transfer_int16."""
        with torch.inference_mode():
            y = self.model(placed).float()
            return encode_int16(y) if self.options.transfer_int16 else y

    def _start_download(self, y: torch.Tensor, host: torch.Tensor):
        """Copy device result `y` into host tensor `host`. On CUDA the copy
        runs on the side stream once the compute stream has reached this
        point, and the returned event marks its end; on the CPU it is done
        at once (None)."""
        if not self._cuda:
            host.copy_(y)
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self._copy_stream.wait_event(ready)
        with torch.cuda.stream(self._copy_stream):
            host.copy_(y, non_blocking=True)
        # the caching allocator must not hand y's memory to a later batch
        # before the side stream has read it
        y.record_stream(self._copy_stream)
        copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        return copied

    def _dispatch_device(self, placed: torch.Tensor, host: torch.Tensor):
        """Launch one device step (the model, then the copy of its stems
        into `host`); returns what `_fetch_device` waits on."""
        return self._start_download(self._run_model(placed), host)

    @staticmethod
    def _fetch_device(copied) -> None:
        """Wait until the copy of one step's stems has reached the host."""
        with profiling.span("device.wait"):
            if copied is not None:
                copied.synchronize()

    def _postfetch(self, arr: np.ndarray) -> np.ndarray:
        if arr.dtype == np.int16:  # transfer_int16 epilogue
            return arr.astype(np.float32) / PCM16_TRANSFER_SCALE
        return arr

    def _call_device(self, placed: torch.Tensor) -> np.ndarray:
        """One device step from start to end: the model on a placed batch
        (n, C, seg), its stems copied into a host buffer and waited for ->
        (n, S, C, seg) f32 (int16 transfers decoded). The feeder's step."""
        host = self._host_buffer((placed.shape[0], self.num_sources, *placed.shape[1:]),
                                 self._out_dtype())
        self._fetch_device(self._dispatch_device(placed, host))
        return self._postfetch(host.numpy())

    def _run_batched(self, batch: np.ndarray,
                     progress: ProgressCallback) -> np.ndarray:
        bs = self.options.batch_size
        n = batch.shape[0]
        n_calls = math.ceil(n / bs)
        out = self._host_buffer((n, self.num_sources) + batch.shape[1:], self._out_dtype())

        if self.options.fine_progress:
            # serial path: the stage marks of a call are emitted after it
            padded_n = n_calls * bs
            for i in range(0, n, bs):
                done = i // bs

                def to_global(frac, msg, _done=done):
                    progress((_done + frac) / n_calls, msg)

                with profiling.span("batch.place"):
                    placed = self._place(batch[i:i + bs])
                with stage_tracing(), stage_sink(to_global, self.device):
                    with profiling.span("batch.launch"):
                        copied = self._dispatch_device(placed, out[i:i + bs])
                    self._fetch_device(copied)
                progress(min((i + bs) / padded_n, 1.0),
                         f"segments {min(i + bs, n)}/{n}")
            return self._postfetch(out.numpy())

        # pipelined path: up to pipeline_depth steps in flight; launching
        # returns at once, only the fetch waits
        depth = max(1, self.options.pipeline_depth)
        inflight: collections.deque = collections.deque()
        fetched = 0

        def drain_one():
            nonlocal fetched
            self._fetch_device(inflight.popleft())
            fetched += 1
            progress(fetched / n_calls, f"segments {min(fetched * bs, n)}/{n}")

        for i in range(0, n, bs):
            with profiling.span("batch.place"):
                placed = self._place(batch[i:i + bs])
            with profiling.span("batch.launch"):
                inflight.append(self._dispatch_device(placed, out[i:i + bs]))
            if len(inflight) >= depth:
                drain_one()
        while inflight:
            drain_one()
        return self._postfetch(out.numpy())

    # --- host side of a track ---------------------------------------------

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
        with profiling.span("track.prepare"):
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
        with profiling.span("track.finish"):
            combined = overlap_add(chunk_out, meta, shifted_len, segment,
                                   triangle_weight(segment, o.transition_power))
            out = combined[:, :, max_shift - offset:max_shift - offset + N]
            return out * ref_std + ref_mean

    # --- fused whole-track path ---------------------------------------------
    # One (C, L) upload and one (S, C, L) download per track: the split,
    # the model in sub-batches and the weighted overlap-add run on the
    # device. The overlap-add sums in f32 there (the host path in f64).

    def _fused_track_fn(self, n_seg: int, length: int,
                        min_n: int | None = None) -> FusedTrackProgram:
        """The fused pass of one (n_seg, padded-length) bucket, exact for
        any true track length n_true in (min_n - 1, length]: a
        `FusedTrackProgram`, called as fn(x, torch.tensor(n_true)), kept
        in `_fused_cache`."""
        o = self.options
        if min_n is None:  # exact-snap bucket: n_true in (length-stride, length]
            min_n = length - int((1 - o.overlap) * o.segment_samples) + 1
        key = (n_seg, length, min_n)
        fn = self._fused_cache.get(key)
        if fn is not None:
            self._fused_cache.move_to_end(key)
            return fn
        fn = FusedTrackProgram(self.model, self.num_sources, o, n_seg, length, min_n,
                               max(1, o.fused_sub_batch or self._fused_auto_sub()),
                               self.device)
        profiling.count("plans_built")
        self._fused_cache[key] = fn
        if (self.fused_cache_limit is not None
                and len(self._fused_cache) > self.fused_cache_limit):
            self._fused_cache.popitem(last=False)
        return fn

    def _fused_auto_sub(self) -> int:
        """Auto segments per model call of the fused pass: min(2, batch)."""
        return max(1, min(2, self.options.batch_size))

    def _bucket_nseg(self, n_seg_true: int) -> tuple[int, int]:
        """Snap a true segment count up to its bucket.
        Returns (bucket_n_seg, previous_bucket_n_seg)."""
        if self.options.fused_buckets == "exact":
            return n_seg_true, n_seg_true - 1
        if self.options.fused_buckets != "geo":
            raise ValueError(
                f"unknown fused_buckets {self.options.fused_buckets!r}"
                " (choices: 'exact', 'geo')")
        b, prev = 1, 0
        while b < n_seg_true:
            prev, b = b, max(b + 1, math.ceil(b * 1.25))
        return b, prev

    def _fused_prepare(self, audio: np.ndarray,
                       progress: ProgressCallback = null_progress):
        """Prep one track for the fused pass: normalize/shift/pad, the
        int16 encode with transfer_int16, upload. Returns (fn, placed,
        n_true, state); the pass is fn(placed as f32, torch.tensor(n_true))."""
        o = self.options
        with profiling.span("track.prepare"):
            shifted, (max_shift, offset, N, ref_mean, ref_std) = \
                self._normalize_shift(audio, progress)
            seg = o.segment_samples
            stride = int((1 - o.overlap) * seg)
            n_true = shifted.shape[-1]
            # snap the segment count up to its bucket; the pass is exact
            # for any n_true inside it
            n_seg, prev_b = self._bucket_nseg(math.ceil(n_true / stride))
            Lp = n_seg * stride
            if Lp != n_true:
                shifted = np.pad(shifted, ((0, 0), (0, Lp - n_true)))
            up = shifted
            if o.transfer_int16:
                up = np.clip(np.round(shifted * PCM16_TRANSFER_SCALE),
                             -32768, 32767).astype(np.int16)
        with profiling.span("track.plan"):
            fn = self._fused_track_fn(n_seg, Lp, min_n=prev_b * stride + 1)
        with profiling.span("track.place"):
            placed = self._place(up)
        return fn, placed, n_true, (n_seg, max_shift, offset, N, ref_mean, ref_std)

    def warmup(self, lengths_samples) -> None:
        """Run the fused pass once on silence of each length, which builds
        (and caches) its bucket's plan and warms the device's kernels."""
        for L in lengths_samples:
            self.separate_fused(np.zeros((2, int(L)), np.float32))

    def _fused_dispatch(self, audio: np.ndarray,
                        progress: ProgressCallback = null_progress):
        """Prep and launch one track's fused pass and the copy of its
        stems; returns (copied, host buffer, finish state)."""
        fn, placed, n_true, state = self._fused_prepare(audio, progress)
        with profiling.span("track.launch", model_calls=fn.model_calls), \
                torch.inference_mode():
            x = placed.float() / PCM16_TRANSFER_SCALE if placed.dtype == torch.int16 else placed
            y = fn(x, torch.tensor(n_true))
            if self.options.transfer_int16:
                y = encode_int16(y)
        with profiling.span("track.alloc"):
            blocks = self._pinned_blocks()
            host = self._host_buffer(y.shape, y.dtype)
            grown = self._pinned_blocks() - blocks
            if grown:
                profiling.count("result_allocs", grown)
        with profiling.span("track.download"):
            return self._start_download(y, host), host, state

    def _fused_collect(self, copied, host: torch.Tensor, state,
                       progress: ProgressCallback = null_progress) -> np.ndarray:
        n_seg, max_shift, offset, N, ref_mean, ref_std = state
        self._fetch_device(copied)
        with profiling.span("track.finish"):
            y = self._postfetch(host.numpy())
            progress(1.0, f"segments {n_seg}/{n_seg}")
            out = y[:, :, max_shift - offset:max_shift - offset + N]
            return out * ref_std + ref_mean

    def separate_fused(self, audio: np.ndarray,
                       progress: ProgressCallback = null_progress
                       ) -> np.ndarray:
        """(C, N) -> (S, C, N) as one fused device pass for the whole track."""
        return self._fused_collect(*self._fused_dispatch(audio, progress), progress)

    def __call__(self, audio: np.ndarray,
                 progress: ProgressCallback = null_progress) -> np.ndarray:
        """(C, N) float32 -> (S, C, N) float32."""
        if self.options.fused_track:
            return self.separate_fused(audio, progress)
        batch, state = self._prepare(audio, progress)
        chunk_out = self._run_batched(batch, progress)
        return self._finish(chunk_out, state)

    def separate_many(self, tracks: list[np.ndarray],
                      progress: ProgressCallback = null_progress
                      ) -> list[np.ndarray]:
        """Several tracks. Batched path: every track's segments join one
        global batch, so short tracks never waste device steps. Fused path:
        one pass per track, track k+1's launched behind track k's fetch, up
        to pipeline_depth tracks in flight. Each track is a request of its
        own in the spans."""
        fused = self.options.fused_track
        with profiling.span("separate_many", path="fused" if fused else "batched",
                            tracks=len(tracks)):
            if fused:
                outs = []
                depth = max(1, self.options.pipeline_depth)
                inflight: collections.deque = collections.deque()

                def drain_one():
                    rid, job = inflight.popleft()
                    with profiling.request(rid):
                        outs.append(self._fused_collect(*job))
                    progress(len(outs) / len(tracks), f"tracks {len(outs)}/{len(tracks)}")

                for tr in tracks:
                    with profiling.request() as rid:
                        job = self._fused_dispatch(tr)
                    inflight.append((rid, job))
                    if len(inflight) >= depth:
                        drain_one()
                while inflight:
                    drain_one()
                return outs
            batches, states, rids = [], [], []
            for tr in tracks:
                with profiling.request() as rid:
                    b, s = self._prepare(tr, null_progress)
                batches.append(b)
                states.append(s)
                rids.append(rid)
            flat = np.concatenate(batches)
            out = self._run_batched(flat, progress)
            results, pos = [], 0
            for b, s, rid in zip(batches, states, rids):
                with profiling.request(rid):
                    results.append(self._finish(out[pos:pos + len(b)], s))
                pos += len(b)
            return results


class FusedTrackProgram(torch.nn.Module):
    """The fused whole-track pass of one (n_seg, padded-length) bucket:
    (track (C, length) f32, n_true 0-d int tensor) -> (S, C, length)
    stems of the normalized track, exact for any true length n_true in
    (min_n - 1, length].

    The track is cut into n_seg windows of `segment_samples` at the
    stride. The tail windows reproduce split_into_segments' symmetric
    padding by rotating the zero-padded raw slice into place (all
    samples past the true length are zeros, so the rotation is the
    symmetric pad); their stems are rotated back and their overlap-add
    weights masked to the true chunk length. Windows full for every
    length of the bucket ("static") take the full weight, whose sum is
    computed once. The model runs on `sub` windows at a time, and the
    weighted overlap-add sums in f32 on the device (the host path in
    f64).

    n_true is a tensor, and each dynamic tail's rotation an index gather
    computed from it, so one traced program (`serving.DemixSession.
    export_track_program`) serves the whole bucket."""

    def __init__(self, model: torch.nn.Module, num_sources: int, options: ApplyOptions,
                 n_seg: int, length: int, min_n: int, sub: int, device: torch.device):
        super().__init__()
        self.model = model
        self.num_sources = num_sources
        self.seg = options.segment_samples
        self.stride = int((1 - options.overlap) * self.seg)
        self.length = length
        self.offs = list(range(0, length, self.stride))
        assert len(self.offs) == n_seg, (len(self.offs), n_seg)
        self.is_dyn = [off + self.seg > min_n for off in self.offs]
        self.ext = self.offs[-1] + self.seg  # accumulator length (last window overhangs)
        self.sub = sub
        self.model_calls = -(-n_seg // sub)
        w_full = triangle_weight(self.seg, options.transition_power)
        sum_w_static = np.zeros(self.ext, np.float64)
        for off, dyn in zip(self.offs, self.is_dyn):
            if not dyn:
                sum_w_static[off:off + self.seg] += w_full
        self.register_buffer("w", torch.from_numpy(w_full).to(device))
        self.register_buffer("wsum_static", torch.from_numpy(
            sum_w_static.astype(np.float32)).to(device))
        self.register_buffer("pos", torch.arange(self.seg, device=device))

    def forward(self, x: torch.Tensor, n_true: torch.Tensor) -> torch.Tensor:
        seg, n = self.seg, n_true.to(torch.int64)
        # (C, length) -> (n_seg, C, seg): windows of the padded track
        x = F.pad(x, (0, self.ext - self.length))
        batch = x.unfold(1, seg, self.stride).transpose(0, 1)
        segs, tails = [], {}
        for i, (off, dyn) in enumerate(zip(self.offs, self.is_dyn)):
            b = batch[i]
            if dyn:
                clen = torch.clamp(n - off, 0, seg)
                left = torch.div(seg - clen, 2, rounding_mode="floor")
                tails[i] = (clen, left)
                # torch.roll(b, left, -1): out[j] = b[(j - left) mod seg]
                b = b.index_select(-1, torch.remainder(self.pos - left, seg))
            segs.append(b)
        batch = torch.stack(segs)
        y = torch.zeros((self.num_sources, x.shape[0], self.ext), device=x.device)
        wsum = self.wsum_static.clone()
        for g in range(0, len(self.offs), self.sub):
            out = self.model(batch[g:g + self.sub]).float()
            for j, oi in enumerate(out):
                i = g + j
                off = self.offs[i]
                wm = self.w
                if i in tails:
                    clen, left = tails[i]
                    oi = oi.index_select(-1, torch.remainder(self.pos + left, seg))
                    wm = self.w * (self.pos < clen)
                    wsum[off:off + seg] += wm
                y[:, :, off:off + seg].addcmul_(oi, wm)
        return y[:, :, :self.length] / torch.clamp(wsum[:self.length], min=1e-12)


class SequentialBagSeparator(Separator):
    """The htdemucs_ft bag as its models one after another on one device
    path: the port of `demucs_tpu.pipeline.SequentialBagSeparator`, as
    `Separator(BagOfModels(models))`.

    The batched path runs each model in turn on the placed batch and keeps
    stem i of model i on the device (`models.BagOfModels`), so a batch
    still has one upload and one download. The fused form uploads the
    track once, runs every model on each group of segments and downloads
    only stem i of model i. The JAX class's FAILED_PRECONDITION retry has
    no counterpart. Like `Separator`, one call at a time: a threaded
    server's concurrent requests go through a `service.DeviceFeeder`.
    """

    def __init__(self, models, num_sources: int, options: ApplyOptions | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(BagOfModels(models), num_sources, options, device)

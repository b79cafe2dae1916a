"""Offline separation of a batch of songs through `Separator.separate_many`.

The mix names the separator's options (the CLI's `--fused` ones), the
song-length distribution and how many songs go to one call. Every call
holds the same `per_call` lengths, the distribution's quantiles, in an
order and at offsets into the seeded base signal of its own, so every
seed and every call does the same work. Set-up builds the model from
the seed, makes the base signal, and separates one call of songs, which
builds every length's fused plan (with its single-segment group where
the count is odd), pinned buffers and device allocations before the
window opens. The window then makes
`separate_many` calls until `--seconds` have passed; the rate is all
the audio of the calls over all the window's wall time. Each call's
wall time goes to standard error. A traced run profiles call 1 (host
activity and shapes) and call 2 (device activity alone), runs at least
three calls and leaves the traced ones out of `mfu`. The stems of the
first call's longest song and of one of its songs drawn from the seed
are held against the reference.
"""

from __future__ import annotations

import contextlib
import sys
import time

from ..harness import program, signals, traffic
from ..harness.core import Run
from ..harness.trace import Stretch, merged, spanned
from ..reference import compare, track
from .common import Marks, ReferenceCache, peak_bytes, release, sync


def _segments(n: int, cfg: dict) -> int:
    """Segments of a song of n samples after the shift pad, as the
    reference's split counts them."""
    a = cfg["apply"]
    seg = a["segment_samples"]
    max_shift = int(a["max_shift_secs"] * a["sample_rate"])
    n_true = n + max_shift - track.shift_offset(max_shift, a["shift_seed"])
    return -(-n_true // int((1 - a["overlap"]) * seg))


def measure(run: Run, t_start: float) -> dict:
    from demucs_tpu_torch.pipeline import Separator

    cfg, tr, dev = run.cfg, run.traffic, run.device
    a = cfg["apply"]
    per_call = tr["per_call"]
    marks = Marks(t_start)
    marks("imports")
    weights = program.seeded_weights(cfg, run.seed, dev)
    model = program.build(cfg, weights, dev)
    sep = Separator(model, len(cfg["sources"]), program.apply_options(cfg, tr["options"]), dev)
    marks("model")
    base = signals.base_signal(tr["base_audio_s"], run.seed, dev)

    def call_songs(c: int) -> list:
        return signals.songs(base, traffic.song_lengths(tr["lengths"], per_call, run.seed, c),
                             run.seed, c)

    first = call_songs(-1)
    marks("songs")
    sep.separate_many(first)
    sync(dev)
    marks("warm, one call")
    run.setup_s = marks.report("set-up")

    # the songs checked: the longest and one drawn from the seed, of call 0
    songs0 = call_songs(0)
    longest = max(range(per_call), key=lambda j: songs0[j].shape[-1])
    drawn = int(traffic.rng(run.seed, 20).integers(per_call))
    kept: dict = {}
    audio_s = segments = calls = 0
    untraced_s = untraced_segments = 0.0
    traced: dict = {}
    t0 = time.perf_counter()
    # a traced run's window holds both traced calls, however long they take
    while time.perf_counter() - t0 < run.seconds or (run.trace and calls < 3):
        songs = songs0 if calls == 0 else call_songs(calls)
        # traced runs: call 1 with host activity and shapes, call 2 with
        # device activity alone (see harness/trace.py)
        kind = {1: "shapes", 2: "timing"}.get(calls) if run.trace else None
        t_call = time.perf_counter()
        with Stretch(kind is not None, dev, shapes=kind == "shapes") as stretch, \
                (spanned(sep, "_fused_dispatch", "_fused_collect") if kind == "shapes"
                 else contextlib.nullcontext()):
            outs = sep.separate_many(songs)
        call_s = time.perf_counter() - t_call
        n_seg = sum(_segments(song.shape[-1], cfg) for song in songs)
        print(f"portbench: call {calls} {call_s:.3f} s, {n_seg} segments"
              f"{' (' + kind + ')' if kind else ''}", file=sys.stderr)
        if kind is None:
            untraced_s += call_s
            untraced_segments += n_seg
        else:
            traced[kind] = stretch.read()
        segments += n_seg
        audio_s += sum(song.shape[-1] for song in songs) / a["sample_rate"]
        if calls == 0:
            kept = {j: (songs[j], outs[j]) for j in {longest, drawn}}
        calls += 1
    sync(dev)
    run.window_s = time.perf_counter() - t0
    if traced:
        run.summary = merged(traced["shapes"], traced["timing"])
    run.attempted = calls * per_call
    run.e2e["separate_audio_s_per_s"] = audio_s / run.window_s
    # the model's operations over the calls that ran without the profiler
    run.counters.update(songs=calls * per_call, calls=calls, audio_s=audio_s,
                        segments=segments,
                        operations=untraced_segments * cfg["operations_per_segment"],
                        operations_s=untraced_s)
    run.memory_peak_bytes = peak_bytes(dev)
    del sep, model, weights, outs
    release(dev)
    return {"songs": {j: v[0] for j, v in kept.items()}, "outs": {j: v[1] for j, v in kept.items()}}


def check(run: Run, kept: dict, cache: ReferenceCache | None = None) -> dict:
    """stem_rel_err: the worst stem's relative L2 distance from the
    reference over the kept songs."""
    cache = cache or ReferenceCache(run)
    return {"stem_rel_err": max(compare.stem_rel_err(kept["outs"][j], cache.stems(j, song))
                                for j, song in kept["songs"].items())}


def control(run: Run, kept: dict, cache: ReferenceCache) -> dict:
    """The same number for the reference computed with TF32 on, in the
    program's place."""
    return {"stem_rel_err": max(
        compare.stem_rel_err(cache.stems(j, song, tf32=True), cache.stems(j, song))
        for j, song in kept["songs"].items())}


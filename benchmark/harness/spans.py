"""What the readers of the program's own spans and counters share.

The program (`demucs_tpu_torch/utils/profiling.py`) records its spans
while a `torch.profiler` session runs, so a `--trace 1` run's profiled
stretches fill its buffer, and nothing else does. After the run a reader
takes `profiling.spans()` (records with `name`, `start_ns`, `end_ns`,
`parent`, `request`, `thread`, `attrs`, and on a root span `counts`)
and reads only the device-only timing stretch, the last one profiled:
the last `separate_many` root of an offline run (its call 2), the last
`traced_steps` `train.step` roots of a training run.

Each reader returns None where there is nothing to read: off the card, a
program without spans, no root of that name.
"""

from __future__ import annotations

from .core import Run

NS_PER_MS = 1e6


def program_spans(run: Run) -> list[dict] | None:
    """The program's span buffer after the run, or None (not on the card,
    or a program that records no spans)."""
    if run.device.type != "cuda":
        return None
    from demucs_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def _ms(rec: dict) -> float:
    return (rec["end_ns"] - rec["start_ns"]) / NS_PER_MS


def roots(spans: list[dict], name: str) -> list[dict]:
    """The root spans called `name`, by start."""
    return sorted((s for s in spans if s["name"] == name and s["parent"] is None),
                  key=lambda s: s["start_ns"])


def within(spans: list[dict], root: dict, name: str) -> list[dict]:
    """The spans called `name` on the root's thread inside its interval."""
    return [s for s in spans if s["name"] == name and s["thread"] == root["thread"]
            and root["start_ns"] <= s["start_ns"] and s["end_ns"] <= root["end_ns"]]


# a track's host work that does not wait on the card: the numpy
# normalize, shift and pad, the plan's lookup, the copy into pinned
# staging, the result's pinned buffer, the numpy denormalize. Left out:
# `track.launch` and `track.download`, which enqueue on the card and
# may wait for room in its queue, and every `device.wait`.
HOST_SPANS = ("track.prepare", "track.plan", "track.place", "track.alloc", "track.finish")
REBUILD_COUNTS = ("plans_built", "staging_allocs", "result_allocs")


def host_ms_per_song(spans: list[dict] | None) -> float | None:
    """The last `separate_many` call's host work a track, in ms: its
    HOST_SPANS less the `device.wait` spans inside them, over its
    tracks."""
    calls = roots(spans or [], "separate_many")
    if not calls or not calls[-1]["attrs"].get("tracks"):
        return None
    call = calls[-1]
    host = [s for name in HOST_SPANS for s in within(spans, call, name)]
    ids = {s["id"] for s in host}
    waited = sum(_ms(s) for s in within(spans, call, "device.wait") if s["parent"] in ids)
    return (sum(_ms(s) for s in host) - waited) / call["attrs"]["tracks"]


def rebuilds(spans: list[dict] | None) -> int | None:
    """Set-up work the last `separate_many` call paid again: fused plans
    built, pinned staging buffers (re)allocated and pinned blocks the
    result buffers added to the caching host allocator, on its thread."""
    calls = roots(spans or [], "separate_many")
    if not calls:
        return None
    counts = calls[-1]["counts"]
    return sum(counts.get(name, 0) for name in REBUILD_COUNTS)


def data_ms_per_step(spans: list[dict] | None, steps: int) -> float | None:
    """The host ms a step of the last `steps` training steps spent in the
    data spans (`data.*` roots: sampling, augmentation), taken between
    the end of the step before them and the end of the last."""
    all_steps = roots(spans or [], "train.step")
    if steps < 1 or len(all_steps) < steps:
        return None
    last = all_steps[-steps:]
    lo = all_steps[-steps - 1]["end_ns"] if len(all_steps) > steps else -1
    hi = last[-1]["end_ns"]
    data = [s for s in spans if s["parent"] is None and s["name"].startswith("data.")
            and s["thread"] == last[-1]["thread"] and lo <= s["start_ns"]
            and s["end_ns"] <= hi]
    if not data:
        return None
    return sum(_ms(s) for s in data) / steps

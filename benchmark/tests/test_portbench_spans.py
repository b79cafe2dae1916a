"""The readers of the program's spans (`harness/spans.py` and the metrics
`host_ms_per_song.offline`, `rebuilds_in_window.offline`,
`data_ms_per_step.train`) on synthetic span buffers, the cases with
nothing to read among them."""

from __future__ import annotations

import itertools

import pytest
import torch

from benchmark.harness import core, spans

_ids = itertools.count(1)
MS = 1_000_000


def _span(name, start_ms, end_ms, parent=None, thread=1, attrs=None, counts=None):
    return {"id": next(_ids), "name": name, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "parent": None if parent is None else parent["id"],
            "request": 0, "thread": thread, "attrs": attrs or {}, "counts": counts or {}}


def _offline_call(t0, tracks=2, counts=None, launch_ms=50):
    """One call of one track's spans: 10 ms prepare, 1 ms plan, 10 ms
    place holding a 4 ms staging wait, the launch, 2 ms alloc, 1 ms
    download, 7 ms waiting for the stems, 15 ms finish."""
    t = t0
    root = _span("separate_many", t0, t0 + 46 + launch_ms,
                 attrs={"path": "fused", "tracks": tracks}, counts=counts)
    recs = []
    for name, ms in (("track.prepare", 10), ("track.plan", 1), ("track.place", 10),
                     ("track.launch", launch_ms), ("track.alloc", 2), ("track.download", 1),
                     ("device.wait", 7), ("track.finish", 15)):
        recs.append(_span(name, t, t + ms, parent=root))
        if name == "track.place":
            recs.append(_span("device.wait", t + 2, t + 6, parent=recs[-1]))
        t += ms
    return [*recs, root]


def test_host_ms_per_song_reads_the_last_calls_host_spans_less_their_waits():
    buf = _offline_call(0, launch_ms=500) + _offline_call(1000, tracks=4)
    # another thread's spans inside the call's interval are not the call's
    buf.append(_span("track.prepare", 1010, 1020, thread=2))
    assert spans.host_ms_per_song(buf) == pytest.approx((10 + 1 + 10 - 4 + 2 + 15) / 4)


@pytest.mark.parametrize("launch_ms", [1, 50, 5000])
def test_host_ms_per_song_leaves_the_launch_out(launch_ms):
    # a launch held up by a full queue on the card is not host work
    assert spans.host_ms_per_song(_offline_call(0, launch_ms=launch_ms)) == pytest.approx(17.0)


def test_rebuilds_reads_the_last_calls_counts():
    buf = _offline_call(0, counts={"plans_built": 5, "staging_allocs": 2})
    assert spans.rebuilds(buf) == 7
    buf += _offline_call(200, counts={"staging_allocs": 1, "staging_bytes": 4096})
    assert spans.rebuilds(buf) == 1
    buf += _offline_call(400, counts={"result_allocs": 3, "plans_built": 1})
    assert spans.rebuilds(buf) == 4
    buf += _offline_call(600)
    assert spans.rebuilds(buf) == 0


def _train_steps(n, t0=0, data=True):
    buf = []
    for k in range(n):
        t = t0 + 100 * k
        if data:
            buf.append(_span("data.sample", t, t + 5))
            buf.append(_span("data.augment", t + 6, t + 8))
        step = _span("train.step", t + 10, t + 90)
        buf += [_span("train.forward", t + 10, t + 40, parent=step), step]
    return buf


def test_data_ms_per_step_reads_the_last_steps():
    # two traced stretches of 3 steps: only the last 3 steps' data count
    buf = _train_steps(3) + _train_steps(3, t0=300)
    buf[0]["end_ns"] = 50 * MS  # a slow sample in the first stretch
    assert spans.data_ms_per_step(buf, 3) == pytest.approx(7.0)
    # the buffer holds just the steps read
    assert spans.data_ms_per_step(_train_steps(3), 3) == pytest.approx(7.0)


@pytest.mark.parametrize("case", ["empty", "none", "no_root", "too_few_steps", "no_data"])
def test_readers_find_nothing_to_read(case):
    buf = {"empty": [], "none": None, "no_root": [_span("track.prepare", 0, 1)],
           "too_few_steps": _train_steps(2), "no_data": _train_steps(3, data=False)}[case]
    assert spans.data_ms_per_step(buf, 3) is None
    if case != "no_data" and case != "too_few_steps":
        assert spans.host_ms_per_song(buf) is None and spans.rebuilds(buf) is None


def test_the_metric_files_read_the_programs_buffer(monkeypatch):
    from demucs_tpu_torch.utils import profiling

    run = core.Run(workload="htdemucs_4s.offline", seed=1, seconds=1.0, trace=True,
                   device=torch.device("cuda", 0), cfg={}, traffic={"traced_steps": 3})
    buf = _offline_call(0, counts={"plans_built": 1}) + _train_steps(3)
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in buf])
    assert core.read_metric("host_ms_per_song.offline", run) == pytest.approx(17.0)
    assert core.read_metric("rebuilds_in_window.offline", run) == 1
    assert core.read_metric("data_ms_per_step.train", run) == pytest.approx(7.0)
    # off the card, and beside a program without spans, nothing to read
    monkeypatch.delattr(profiling, "spans")
    for name in ("host_ms_per_song.offline", "rebuilds_in_window.offline",
                 "data_ms_per_step.train"):
        assert core.read_metric(name, run) is None
        assert core.read_metric(name, core.Run(**{**run.__dict__,
                                                  "device": torch.device("cpu")})) is None

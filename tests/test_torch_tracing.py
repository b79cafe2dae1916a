"""The port's spans and counters (`demucs_tpu_torch/utils/profiling.py`) and
where the program opens them: nesting, parents and requests per thread;
nothing recorded and no `record_function` entered while tracing is off;
one clock with the profiler's trace; the fused and batched track paths'
spans, `plans_built` and `result_allocs`; a training step's phases; the feeder's queue
wait."""

import json
import threading

import numpy as np
import pytest
import torch

from demucs_tpu_torch.data import Augmentation, SegmentSampler, augmented_step
from demucs_tpu_torch.pipeline import ApplyOptions, Separator
from demucs_tpu_torch.service import DeviceFeeder
from demucs_tpu_torch.train import TrainStep
from demucs_tpu_torch.utils import profiling

from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 256
TRACK_STEPS = ("track.prepare", "track.plan", "track.place", "track.launch", "track.alloc",
               "track.download", "device.wait", "track.finish")


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


class _Toy(torch.nn.Module):
    """stems = x * (i + 1) for i in 0, 1."""

    def forward(self, mix):
        return torch.stack([mix * (i + 1) for i in range(2)], dim=1)


def _separator(fused: bool, batch_size: int = 2) -> Separator:
    return Separator(_Toy(), 2, ApplyOptions(segment_samples=SEG, batch_size=batch_size,
                                             shift_offset=0, max_shift_secs=0.0,
                                             fused_track=fused),
                     device="cpu")


def _tracks(*lengths) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, n)).astype(np.float32) for n in lengths]


def _by_id(records):
    return {r["id"]: r for r in records}


def _root_of(rec, ids):
    while rec["parent"] is not None:
        rec = ids[rec["parent"]]
    return rec


def test_spans_nest_with_parents_and_requests_per_thread():
    opened = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.outer", tag=tag):
            with profiling.span(f"{tag}.inner"):
                profiling.count("items", 2)
                opened.wait()  # both threads hold their spans open at once
            with profiling.request() as rid:
                with profiling.span(f"{tag}.own"):
                    pass
            with profiling.request(rid):
                with profiling.span(f"{tag}.own_again"):
                    pass

    with profiling.tracing():
        other = threading.Thread(target=work, args=("b",))
        other.start()
        work("a")
        other.join(timeout=30)
    assert not other.is_alive()
    recs = profiling.spans()
    assert len(recs) == 8
    ids = _by_id(recs)
    names = {r["name"]: r for r in recs}
    for tag in "ab":
        outer, inner = names[f"{tag}.outer"], names[f"{tag}.inner"]
        own, again = names[f"{tag}.own"], names[f"{tag}.own_again"]
        assert outer["parent"] is None and outer["attrs"] == {"tag": tag}
        assert inner["parent"] == own["parent"] == again["parent"] == outer["id"]
        assert inner["request"] == outer["request"]
        # request(): a request of its own inside the outer span, taken up again by id
        assert own["request"] == again["request"] != outer["request"]
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
        assert {ids[r["parent"]]["thread"] for r in (inner, own)} == {outer["thread"]}
        # a root's counts are its own thread's
        assert outer["counts"] == {"items": 2} and inner["counts"] == {}
    assert names["a.outer"]["thread"] != names["b.outer"]["thread"]
    assert names["a.outer"]["request"] != names["b.outer"]["request"]
    assert profiling.counters() == {"items": 4}
    # copies: changing them leaves the buffer as it was
    recs[0]["attrs"]["x"] = 1
    assert "x" not in profiling.spans()[0]["attrs"]
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_tracing_off_records_nothing_and_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.enabled()
    with profiling.span("x", a=1) as s, profiling.request() as rid:
        profiling.count("n")
        assert s is None and rid is None and profiling.current_request() is None
    profiling.record("q", 0, 1)
    _separator(fused=True).separate_many(_tracks(600, 900))
    _separator(fused=False).separate_many(_tracks(600, 900))
    assert profiling.spans() == []
    # counters are always on
    assert profiling.counters() == {"n": 1, "plans_built": 2, "device_norm_tracks": 2}
    with profiling.tracing(), pytest.raises(AssertionError, match="entered"):
        with profiling.span("y"):
            pass


def test_spans_share_the_profiler_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        for i in range(5):
            with profiling.span(f"clock.{i}"):
                torch.ones(64).sum()
    assert not profiling.enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_ns = int(trace["baseTimeNanoseconds"])
    marks = {e["name"]: base_ns + e["ts"] * 1000 for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("clock.")}
    recs = profiling.spans()
    assert sorted(marks) == sorted(r["name"] for r in recs) and len(recs) == 5
    for r in recs:
        assert abs(r["start_ns"] - marks[r["name"]]) < 2e6, (r["name"],
                                                             r["start_ns"] - marks[r["name"]])


def _check_track_requests(recs, root, steps):
    """Every span inside `root` on its thread; each track's spans in a
    request of its own, holding `steps`."""
    ids = _by_id(recs)
    inside = [r for r in recs if r is not root]
    assert all(_root_of(r, ids) is root for r in inside)
    per_request: dict = {}
    for r in inside:
        if r["request"] != root["request"]:
            per_request.setdefault(r["request"], set()).add(r["name"])
    assert len(per_request) == root["attrs"]["tracks"]
    assert all(names == set(steps) for names in per_request.values()), per_request
    return per_request


def test_fused_separate_many_spans_and_plans_built():
    sep = _separator(fused=True)
    # three lengths, two of them in one bucket (the same segment count)
    tracks = _tracks(600, 1000, 600)
    with profiling.tracing():
        first = sep.separate_many(tracks)
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["separate_many"]
    root = roots[0]
    assert root["attrs"] == {"path": "fused", "tracks": 3}
    assert root["counts"] == {"plans_built": 2, "device_norm_tracks": 3}
    _check_track_requests(recs, root, TRACK_STEPS)
    launches = [r for r in recs if r["name"] == "track.launch"]
    assert [r["attrs"]["model_calls"] for r in launches] == [2, 3, 2]  # 4 and 6 segments

    profiling.reset()
    with profiling.tracing():
        again = sep.separate_many(tracks)
    (root,) = [r for r in profiling.spans() if r["parent"] is None]
    # every plan built: nothing paid again
    assert root["counts"] == {"device_norm_tracks": 3}
    assert profiling.counters() == {"device_norm_tracks": 3}
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_fused_counts_the_pinned_pool_growth_of_the_result_buffers(monkeypatch):
    sep = _separator(fused=True)
    sep.separate_many(_tracks(600))  # every plan built
    # the caching host allocator's block count before and after each
    # track's result buffer: the first grows by 1, the second not, the
    # third by 2
    blocks = iter([0, 1, 1, 1, 1, 3])
    monkeypatch.setattr(sep, "_pinned_blocks", lambda: next(blocks))
    profiling.reset()
    with profiling.tracing():
        sep.separate_many(_tracks(600, 1000, 600))
    (root,) = [r for r in profiling.spans() if r["parent"] is None]
    counts = {"plans_built": 1, "result_allocs": 3, "device_norm_tracks": 3}
    assert root["counts"] == counts
    assert profiling.counters() == counts


def test_batched_separate_many_spans():
    sep = _separator(fused=False)
    with profiling.tracing():
        sep.separate_many(_tracks(600, 1000))
    recs = profiling.spans()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["attrs"] == {"path": "batched", "tracks": 2}
    _check_track_requests(recs, root, ("track.prepare", "track.finish"))
    steps = [r for r in recs if r["request"] == root["request"] and r is not root]
    # 4 + 6 segments at batch 2: 5 device steps, each placed, launched and waited for
    assert sorted(r["name"] for r in steps) == sorted(
        ["batch.place", "batch.launch", "device.wait"] * 5)


class _TinyNet(torch.nn.Module):
    def __init__(self, sources: int = 2):
        super().__init__()
        self.sources = sources
        self.conv = torch.nn.Conv1d(2, 2 * sources, 3, padding=1)

    def forward(self, mix):
        y = self.conv(mix)
        return y.view(mix.shape[0], self.sources, 2, mix.shape[-1])


@pytest.mark.parametrize("ema", [None, 0.9])
def test_train_step_phase_spans(ema):
    torch.manual_seed(0)
    step = TrainStep(_TinyNet(), lr=1e-3, ema_decay=ema)
    rng = np.random.default_rng(0)
    sampler = SegmentSampler([rng.standard_normal((2, 2, 4096)).astype(np.float32)], 512,
                             seed=0)
    gen = torch.Generator().manual_seed(0)
    from demucs_tpu_torch.data import draw_augmentation

    with profiling.tracing():
        for _ in range(2):
            stems = torch.from_numpy(sampler.batch(2))
            augmented_step(step, stems, Augmentation(*draw_augmentation(stems.shape, gen)))
    recs = profiling.spans()
    ids = _by_id(recs)
    roots = [r["name"] for r in sorted(recs, key=lambda r: r["start_ns"])
             if r["parent"] is None]
    assert roots == ["data.sample", "data.augment", "train.step"] * 2
    phases = ["train.forward", "train.backward", "train.optimizer"] + (["train.ema"] if ema
                                                                       else [])
    for root in (r for r in recs if r["name"] == "train.step"):
        kids = sorted((r for r in recs if r["parent"] == root["id"]),
                      key=lambda r: r["start_ns"])
        assert [k["name"] for k in kids] == phases
        assert all(_root_of(k, ids) is root and k["request"] == root["request"] for k in kids)
    assert step.step_count == 2


def test_feeder_queue_wait_grows_with_a_queued_request():
    release = threading.Event()

    class _Blocking(_Toy):
        calls = 0

        def forward(self, mix):
            _Blocking.calls += 1
            if _Blocking.calls == 1:
                assert release.wait(30)
            return super().forward(mix)

    sep = Separator(_Blocking(), 2, ApplyOptions(segment_samples=SEG, batch_size=2,
                                                 shift_offset=0, max_shift_secs=0.0),
                    device="cpu")
    feeder = DeviceFeeder(sep, fill_wait_s=0.0)
    try:
        assert feeder.stats["queue_wait_s"] == 0.0 == feeder.stats["queue_wait_max_s"]
        x = np.ones((2, 2, SEG), np.float32)
        with profiling.tracing():
            first = feeder.submit_segments(x)  # its step blocks the feeder
            while _Blocking.calls == 0:
                threading.Event().wait(0.001)
            done = {}
            caller = threading.Thread(
                target=lambda: done.setdefault("out", feeder.separate(_tracks(300)[0])))
            caller.start()
            threading.Event().wait(0.1)  # the second request waits in the queue
            release.set()
            first.result(30)
            caller.join(timeout=30)
        assert not caller.is_alive() and done["out"].shape == (2, 2, 300)
        waited = feeder.stats["queue_wait_s"]
        assert waited >= 0.1 and feeder.stats["queue_wait_max_s"] >= 0.1
        recs = profiling.spans()
        (queued,) = [r for r in recs if r["name"] == "feeder.queue"
                     and r["end_ns"] - r["start_ns"] >= 1e8]
        # the request's own spans: its prepare and finish on the caller's
        # thread, its wait recorded on the feeder's, one request id
        mine = [r for r in recs if r["request"] == queued["request"]]
        assert sorted(r["name"] for r in mine) == ["feeder.queue", "track.finish",
                                                   "track.prepare"]
        assert queued["thread"] == feeder._thread.ident != caller.ident
        assert {r["thread"] for r in mine if r is not queued} == {caller.ident}
        steps = [r for r in recs if r["name"] == "feeder.step"]
        assert steps and all(r["parent"] is None and r["thread"] == feeder._thread.ident
                             for r in steps)
        assert any(r["name"] == "feeder.fill" for r in recs)
        # device.wait inside a feeder step on the feeder's thread
        ids = _by_id(recs)
        waits = [r for r in recs if r["name"] == "device.wait"]
        assert waits and all(ids[r["parent"]]["name"] == "feeder.step" for r in waits)
    finally:
        release.set()
        feeder.close()

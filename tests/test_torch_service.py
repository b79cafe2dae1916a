"""The port's DeviceFeeder (`demucs_tpu_torch/service.py`): the behaviours
of tests/test_service.py on a fake separator, and `feeder.separate`
against a direct `Separator` call on the full-width htdemucs-4s, bit for
bit on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from demucs_tpu_torch import params as P
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_model
from demucs_tpu_torch.pipeline import ApplyOptions, Separator
from demucs_tpu_torch.service import DeviceFeeder

from _torch_threads import _one_torch_thread  # noqa: F401


class _Toy(torch.nn.Module):
    """stems = x * (i + 1) for i in 0, 1; counts its calls, records each
    batch size and raises on call `fail_on`."""

    def __init__(self, fail_on=None):
        super().__init__()
        self.fail_on = fail_on
        self.n = 0
        self.batches = []

    def forward(self, mix):
        self.n += 1
        if self.n == self.fail_on:
            raise ValueError("injected device failure")
        self.batches.append(int(mix.shape[0]))
        return torch.stack([mix * (i + 1) for i in range(2)], dim=1)


def _make_sep(batch_size=4, fail_on=None):
    toy = _Toy(fail_on)
    sep = Separator(toy, 2, ApplyOptions(segment_samples=256, batch_size=batch_size,
                                         shift_offset=0, max_shift_secs=0.0),
                    device="cpu")
    return sep, toy


def test_feeder_routes_outputs_per_item():
    sep, toy = _make_sep(batch_size=4)
    feeder = DeviceFeeder(sep, fill_wait_s=0.05)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 2, 256)).astype(np.float32)
    b = rng.standard_normal((2, 2, 256)).astype(np.float32)
    fa = feeder.submit_segments(a)
    fb = feeder.submit_segments(b)
    out_a, out_b = fa.result(30), fb.result(30)
    np.testing.assert_allclose(out_a[:, 0], a, atol=1e-6)
    np.testing.assert_allclose(out_a[:, 1], 2 * a, atol=1e-6)
    np.testing.assert_allclose(out_b[:, 0], b, atol=1e-6)
    # 5 segments at batch 4: the two items shared a batch
    assert feeder.stats["segments"] == 5
    assert feeder.stats["device_calls"] == 2
    assert feeder.stats["padded"] == 3
    assert toy.batches == [4, 4]  # padded to B
    feeder.close()


def test_feeder_item_spanning_multiple_batches():
    sep, toy = _make_sep(batch_size=2)
    feeder = DeviceFeeder(sep, fill_wait_s=0.0)
    x = np.random.default_rng(1).standard_normal((7, 2, 256)).astype(np.float32)
    out = feeder.submit_segments(x).result(30)
    assert out.shape == (7, 2, 2, 256) and out.dtype == np.float32
    np.testing.assert_allclose(out[:, 1], 2 * x, atol=1e-6)
    assert feeder.stats["device_calls"] == 4  # ceil(7 / 2)
    feeder.close()


def test_feeder_exclusive_fifo_with_segments():
    sep, toy = _make_sep(batch_size=2)
    feeder = DeviceFeeder(sep, fill_wait_s=0.0)
    order = []
    x = np.ones((2, 2, 256), np.float32)
    f1 = feeder.submit_segments(x)
    f2 = feeder.run_exclusive(lambda: order.append(("exclusive", toy.n)) or 42)
    f3 = feeder.submit_segments(x)
    assert f2.result(30) == 42
    f1.result(30)
    f3.result(30)
    # the exclusive call ran after the first batch and before the second
    assert order == [("exclusive", 1)] and toy.n == 2
    assert feeder.stats["exclusive_calls"] == 1
    feeder.close()


def test_feeder_propagates_device_errors_and_recovers():
    sep, toy = _make_sep(batch_size=2, fail_on=1)
    feeder = DeviceFeeder(sep, fill_wait_s=0.0)
    x = np.ones((2, 2, 256), np.float32)
    with pytest.raises(ValueError, match="injected device failure"):
        feeder.submit_segments(x).result(30)
    # the feeder thread survives and serves the next request
    out = feeder.submit_segments(x).result(30)
    assert out.shape == (2, 2, 2, 256)
    feeder.close()


def test_feeder_separate_matches_direct_separator():
    sep, toy = _make_sep(batch_size=4)
    feeder = DeviceFeeder(sep, fill_wait_s=0.0)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 1000)) * 0.3).astype(np.float32)
    ref = sep(audio)
    got = feeder.separate(audio)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    feeder.close()


def test_feeder_concurrent_submitters_share_batches():
    sep, toy = _make_sep(batch_size=8)
    feeder = DeviceFeeder(sep, fill_wait_s=0.2)  # a wide merge window
    rng = np.random.default_rng(3)
    tracks = [rng.standard_normal((2, 2, 256)).astype(np.float32) for _ in range(4)]
    outs = [None] * 4

    def worker(i):
        time.sleep(0.01 * i)
        outs[i] = feeder.submit_segments(tracks[i]).result(30)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tr, out in zip(tracks, outs):
        np.testing.assert_allclose(out[:, 1], 2 * tr, atol=1e-6)
    # 8 segments from 4 submitters fit one batch-8 call
    assert feeder.stats["device_calls"] == 1
    feeder.close()


def test_feeder_closed_rejects():
    sep, _ = _make_sep()
    feeder = DeviceFeeder(sep)
    feeder.close()
    with pytest.raises(RuntimeError):
        feeder.submit_segments(np.zeros((1, 2, 256), np.float32))
    with pytest.raises(RuntimeError):
        feeder.run_exclusive(lambda: None)


def test_feeder_separate_full_width_matches_separator():
    """The full-width htdemucs-4s: the track's 4 segments go through the
    feeder's thread (in inference mode there) in two batches of 2, bit for
    bit the direct call's, with int16 transfers and without."""
    schema = P.htdemucs_schema(HTDEMUCS_4S)
    model = build_model(HTDEMUCS_4S, P.from_state_dict(P.init_flat(schema, seed=0), schema),
                        "cpu")
    rng = np.random.default_rng(4)
    # 40000 samples + the 4096-sample shift pad: 4 segments of 16384
    track = (rng.standard_normal((2, 40000)) * 0.2).astype(np.float32)
    for int16 in (False, True):
        opts = ApplyOptions(batch_size=2, shift_offset=0,
                            transfer_int16=int16).with_segment(16384)
        sep = Separator(model, HTDEMUCS_4S.num_sources, opts, device="cpu")
        ref = sep(track)
        feeder = DeviceFeeder(sep)
        try:
            got = feeder.separate(track)
        finally:
            feeder.close()
        assert feeder.stats["device_calls"] == 2 and feeder.stats["padded"] == 0
        assert got.shape == (4, 2, 40000)
        np.testing.assert_array_equal(got, ref)

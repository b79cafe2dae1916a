"""The generator of traffic and the seeded inputs repeat for a seed and
differ across seeds, every seed gets the same set of sizes, and the
spread that bounds are set from."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import sets
from benchmark.harness import signals, traffic, weights
from benchmark.harness.core import load_json, traffic_file

BIG = 2**31 + 12345


def test_song_lengths_repeat_and_hold_one_set():
    spec = load_json(traffic_file("offline_songs"))["lengths"]
    a = traffic.song_lengths(spec, 8, BIG)
    assert a == traffic.song_lengths(spec, 8, BIG)
    assert a != traffic.song_lengths(spec, 8, BIG + 1)
    assert a != traffic.song_lengths(spec, 8, BIG, batch=1)
    assert sorted(a) == sorted(traffic.song_lengths(spec, 8, 7))
    # the 8 lengths of a call span 60-600 s, and their mean is MUSDB18's 240 s
    q = traffic.length_quantiles(spec, 8)
    assert abs(min(q) - 60.0) < 1e-6 and abs(max(q) - 600.0) < 1e-6
    assert abs(np.mean(q) - 240.0) < 0.01 * 240.0


def test_audio_and_weights_repeat_for_a_seed():
    cpu = torch.device("cpu")
    base = signals.base_signal(4.0, BIG, cpu)
    assert np.array_equal(base, signals.base_signal(4.0, BIG, cpu))
    assert not np.array_equal(base, signals.base_signal(4.0, BIG + 1, cpu))
    s1 = signals.songs(base, [1.0, 2.0], BIG)
    s2 = signals.songs(base, [1.0, 2.0], BIG)
    assert all(np.array_equal(x, y) for x, y in zip(s1, s2))
    stems = signals.stem_tracks(1, 1.0, BIG, cpu)[0]
    assert stems.shape == (4, 2, 44100)
    assert np.array_equal(stems, signals.stem_tracks(1, 1.0, BIG, cpu)[0])
    shapes = [("a.scale", (3,)), ("a.norm1.weight", (3,)), ("a.bias", (3,)), ("a.w", (4, 5))]
    w = weights.seeded_state_dict(shapes, BIG, cpu)
    assert torch.equal(w["a.w"], weights.seeded_state_dict(shapes, BIG, cpu)["a.w"])
    assert not torch.equal(w["a.w"], weights.seeded_state_dict(shapes, BIG + 1, cpu)["a.w"])
    assert abs(float(w["a.scale"].mean()) - 0.5) < 0.05
    assert abs(float(w["a.norm1.weight"].mean()) - 1.0) < 0.1


def test_spread_is_the_interquartile_range_over_the_median():
    # statistics.quantiles' default method: q1 = 1.75, q2 = 3.5, q3 = 5.25
    assert abs(sets.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) - 3.5 / 3.5) < 1e-12
    assert sets.spread([2.0, 2.0, 2.0]) == 0.0

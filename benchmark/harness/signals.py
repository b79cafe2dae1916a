"""Synthetic audio made from the seed on the device: tones plus noise.

A seeded form of `chip_smoke.synthetic_track`: a few tones whose
pitches and slow amplitude envelopes are drawn from the seed, plus white
noise. Songs are slices of one long base signal, each at its own seeded
offset, so that a run makes its audio in one set of large calls.
Training stems are four such signals of different character (a noise
burst track, a low tone, mid tones, a vibrato tone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .weights import generator

SAMPLE_RATE = 44100


def _tones(n: int, channels: int, gen, device, low: float, high: float, count: int,
           env_hz: float, vibrato: float = 0.0) -> torch.Tensor:
    """(channels, n) f32: `count` tones per channel, pitches uniform in
    [low, high) Hz, each under a raised-cosine envelope of about env_hz."""
    t = torch.arange(n, device=device, dtype=torch.float64) / SAMPLE_RATE
    out = torch.zeros(channels, n, device=device, dtype=torch.float64)
    draws = torch.rand(channels, count, 4, generator=gen, device=device, dtype=torch.float64)
    for c in range(channels):
        for k in range(count):
            f, ph, fe, amp = draws[c, k].tolist()
            f = low + (high - low) * f
            env = 0.5 + 0.5 * torch.cos(2 * math.pi * env_hz * (0.5 + fe) * t + 2 * math.pi * ph)
            phase = 2 * math.pi * f * t
            if vibrato:
                phase = phase + vibrato * torch.sin(2 * math.pi * 5.0 * t)
            out[c] += (0.1 + 0.2 * amp) * env * torch.sin(phase + 2 * math.pi * ph)
    return out.float()


def base_signal(seconds: float, seed: int, device) -> np.ndarray:
    """(2, seconds * 44100) f32 on the host: tones plus noise."""
    n = int(seconds * SAMPLE_RATE)
    gen = generator(seed, device, salt=1)
    x = _tones(n, 2, gen, device, 80.0, 1200.0, 4, 0.05)
    x += 0.05 * torch.randn(2, n, generator=gen, device=device)
    return x.cpu().numpy()


def songs(base: np.ndarray, lengths_s: list[float], seed: int,
          batch: int = 0) -> list[np.ndarray]:
    """One (2, n) view of `base` per length, each at a seeded offset (new
    offsets for each `batch`)."""
    rng = np.random.default_rng([seed % 2**63, 2, batch + 1])
    out = []
    for s in lengths_s:
        n = int(round(s * SAMPLE_RATE))
        off = int(rng.integers(0, base.shape[-1] - n + 1))
        out.append(base[:, off:off + n])
    return out


def stem_tracks(count: int, seconds: float, seed: int, device) -> list[np.ndarray]:
    """`count` training tracks, each (4, 2, seconds * 44100) f32 on the
    host: drums (noise under fast envelopes), bass (low tones), other (mid
    tones), vocals (a tone with vibrato), each with a little noise."""
    n = int(seconds * SAMPLE_RATE)
    gen = generator(seed, device, salt=3)
    tracks = []
    for _ in range(count):
        drums = torch.randn(2, n, generator=gen, device=device) * 0.2 * \
            _tones(n, 2, gen, device, 0.0, 0.0, 1, 2.0).abs().add(0.05)
        bass = _tones(n, 2, gen, device, 40.0, 160.0, 2, 0.1)
        other = _tones(n, 2, gen, device, 200.0, 2000.0, 4, 0.2)
        vocals = _tones(n, 2, gen, device, 180.0, 800.0, 1, 0.3, vibrato=2.0)
        stems = torch.stack([drums, bass, other, vocals])
        stems += 0.01 * torch.randn(stems.shape, generator=gen, device=device)
        tracks.append(stems.cpu().numpy())
    return tracks

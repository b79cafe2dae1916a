"""The numbers that decide `correct`: how far what the timed path produced
lies from what the reference computes from the same inputs.
"""

from __future__ import annotations

import numpy as np

# the int16 transfer's step in the normalized track domain (8.0 of
# headroom over 32767 levels), worked out as the serving path states it
PCM16_STEP = 8.0 / 32767.0


def stem_rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """The worst stem's ||out - ref|| / ||ref||, stems on axis 0."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        return float("inf")
    diff = np.sqrt(((out - ref) ** 2).reshape(len(ref), -1).sum(1))
    norm = np.sqrt((ref ** 2).reshape(len(ref), -1).sum(1))
    return float((diff / np.maximum(norm, 1e-30)).max())


def pcm16_step_gap(out: np.ndarray, ref: np.ndarray, audio: np.ndarray) -> float:
    """The widest gap |out - ref| in steps of the int16 transfer, whose
    step in the track's own units is PCM16_STEP times the track's
    mono-reference std (the normalization the path undoes)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        return float("inf")
    std = float(np.asarray(audio, np.float64).mean(0).std(ddof=1))
    return float(np.abs(out - ref).max() / (PCM16_STEP * max(std, 1e-8)))

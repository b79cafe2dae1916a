"""Sinusoidal positional embeddings (Demucs conventions).

The port's copy of `demucs_tpu/ops/embeddings.py`: host-side numpy
constants, static per shape, moved to the device by the caller.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def create_sin_embedding(length: int, dim: int, shift: int = 0,
                         max_period: float = 10000.0) -> np.ndarray:
    """1-D embedding for the time branch: (1, length, dim).

    cos in the first half, sin in the second, with exponent
    arange(half)/(half-1).
    """
    assert dim % 2 == 0
    half = dim // 2
    pos = (np.arange(length, dtype=np.float64) + shift)[:, None]
    adim = np.arange(half, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    emb = np.concatenate([np.cos(phase), np.sin(phase)], axis=-1)
    return emb[None].astype(np.float32)


@functools.lru_cache(maxsize=None)
def create_2d_sin_embedding(d_model: int, height: int, width: int,
                            max_period: float = 10000.0) -> np.ndarray:
    """2-D embedding for the freq branch: (d_model, height, width).

    First d_model/2 channels encode width (time), second half height
    (freq); even channels sin, odd cos.
    """
    assert d_model % 4 == 0
    pe = np.zeros((d_model, height, width), dtype=np.float64)
    half = d_model // 2
    div_term = np.exp(
        np.arange(0, half, 2, dtype=np.float64) * (-np.log(max_period) / half)
    )
    pos_w = np.arange(width, dtype=np.float64)[:, None]   # (W, half/2)
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :]
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :]
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None]
    pe[half + 1::2] = np.cos(pos_h * div_term).T[:, :, None]
    return pe.astype(np.float32)

"""STFT / ISTFT with the exact conventions the Demucs family expects.

The port of the FFT path of `demucs_tpu/dsp.py` (`torch.fft` here, as
`jnp.fft` there off the TPU). The matmul-DFT, radix and parity forms of
the JAX package are TPU layout work and have no counterpart:

  * periodic Hann window of 4096, computed in float64 and cast, so that
    both packages hold the same float32 window;
  * hop 1024, forward scaling 1/sqrt(4096);
  * inverse with window-sumsquare (librosa-style) normalization;
  * the Demucs `_spec`/`_ispec` bookkeeping: reflect pre-pad of
    hop//2*3 samples, frame trim [2:2+le], 2049->2048 bin drop and the
    inverse re-pad.

Framing uses `Tensor.unfold` (a strided view); the overlap-add sums the
four hop-shifted chunk sequences of each frame, as the JAX package does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .utils.device import on_device

FFT_WINDOW_SIZE = 4096
FFT_HOP_SIZE = 1024


@functools.lru_cache(maxsize=None)
def hann_window(n: int = FFT_WINDOW_SIZE) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(n, periodic=True)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_sumsquare(n_frames: int, n: int = FFT_WINDOW_SIZE,
                      hop: int = FFT_HOP_SIZE) -> np.ndarray:
    """Sum of squared, hop-shifted windows (librosa window_sumsquare)."""
    w2 = hann_window(n).astype(np.float64) ** 2
    total = n + hop * (n_frames - 1)
    out = np.zeros(total, dtype=np.float64)
    for i in range(n_frames):
        out[i * hop:i * hop + n] += w2
    return out.astype(np.float32)


def _window(n: int, like: torch.Tensor) -> torch.Tensor:
    return on_device(hann_window, n, device=like.device)


def _pad_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis of a tensor of any rank."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def _overlap_add(frames: torch.Tensor, hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """(..., n_frames, n) -> (..., n + hop*(n_frames-1)) overlap-add:
    each frame is `ratio` hop-chunks, summed at their shifted offsets."""
    n = frames.shape[-1]
    n_frames = frames.shape[-2]
    ratio = n // hop
    out_chunks = n_frames + ratio - 1
    fr = frames.reshape(*frames.shape[:-1], ratio, hop)
    out = frames.new_zeros(*frames.shape[:-2], out_chunks, hop)
    for i in range(ratio):
        out[..., i:i + n_frames, :] += fr[..., i, :]
    return out.reshape(*out.shape[:-2], out_chunks * hop)


def stft(x: torch.Tensor, n_fft: int = FFT_WINDOW_SIZE,
         hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """torch.stft(..., normalized=True, center=True, pad_mode='reflect').

    x: (..., L) real. Returns (..., n_fft//2+1, n_frames) complex64 with
    n_frames = L//hop + 1. L must be a multiple of hop.
    """
    L = x.shape[-1]
    if L % hop:
        raise ValueError(f"stft input length {L} must be a multiple of hop")
    xp = _pad_reflect(x.float(), n_fft // 2, n_fft // 2)
    frames = xp.unfold(-1, n_fft, hop)                 # (..., n_frames, n)
    spec = torch.fft.rfft(frames * _window(n_fft, x), n=n_fft, dim=-1)
    spec = spec * (1.0 / math.sqrt(n_fft))
    return spec.transpose(-1, -2).to(torch.complex64)


def _istft_epilogue(y: torch.Tensor, n_frames: int, length: int,
                    n_fft: int, hop: int) -> torch.Tensor:
    wss = on_device(_window_sumsquare, n_frames, n_fft, hop, device=y.device)
    y = y / torch.clamp(wss, min=1e-11)
    # center=True trim
    return y[..., n_fft // 2: n_fft // 2 + length].float()


def istft(z: torch.Tensor, length: int, n_fft: int = FFT_WINDOW_SIZE,
          hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """torch.istft(..., normalized=True, center=True, length=length).

    z: (..., F, n_frames) complex. Returns (..., length) float32. hop
    must divide n_fft (true of every Demucs config).
    """
    if n_fft % hop:
        raise ValueError(f"istft requires hop | n_fft ({hop}, {n_fft})")
    n_frames = z.shape[-1]
    zt = z.transpose(-1, -2) * math.sqrt(n_fft)        # undo normalized=True
    frames = torch.fft.irfft(zt, n=n_fft, dim=-1)
    y = _overlap_add(frames * _window(n_fft, frames), hop)
    return _istft_epilogue(y, n_frames, length, n_fft, hop)


def spec(x: torch.Tensor, n_fft: int = FFT_WINDOW_SIZE,
         hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """Demucs `_spec`: (..., L) -> (..., n_fft//2, ceil(L/hop)) complex.

    Reflect-pads by hop//2*3 on the left and enough on the right that the
    kept frame count equals ceil(L/hop); drops 2 frames on each side and
    the top frequency bin.
    """
    L = x.shape[-1]
    le = -(-L // hop)  # ceil
    pad = hop // 2 * 3
    pad_right = pad + le * hop - L
    xp = _pad_reflect(x, pad, pad_right)
    z = stft(xp, n_fft, hop)  # padded length (le+3)*hop -> le+4 frames
    return z[..., :-1, 2:2 + le]


def ispec(z: torch.Tensor, length: int, n_fft: int = FFT_WINDOW_SIZE,
          hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """Demucs `_ispec`: inverse of `spec`, producing exactly `length` samples.

    Zero-pads the dropped top bin and the 2+2 trimmed frames back, runs
    ISTFT over the padded span and crops the hop//2*3 pre-pad.
    """
    pad = hop // 2 * 3
    le = hop * (-(-length // hop)) + 2 * pad
    zp = F.pad(z, (2, 2, 0, 1))
    x = istft(zp, le, n_fft, hop)
    return x[..., pad:pad + length]


def cac_pack(z: torch.Tensor) -> torch.Tensor:
    """Complex-as-channels: (..., C, F, T) complex -> (..., 2C, F, T) real,
    channel order [re_c0, im_c0, re_c1, im_c1]."""
    stacked = torch.stack([z.real, z.imag], dim=-3)    # (..., C, 2, F, T)
    return stacked.reshape(*z.shape[:-3], z.shape[-3] * 2, *z.shape[-2:])


def cac_unpack(x: torch.Tensor) -> torch.Tensor:
    """Inverse of cac_pack: (..., 2C, F, T) real -> (..., C, F, T) complex."""
    xs = x.reshape(*x.shape[:-3], x.shape[-3] // 2, 2, *x.shape[-2:])
    return torch.complex(xs[..., 0, :, :], xs[..., 1, :, :])


def cac_pack_fmajor(z: torch.Tensor) -> torch.Tensor:
    """Complex-as-channels, frequency-major: (B, C, F, T) complex ->
    (B, F, 2C, T) real with channel order [re_c0, im_c0, re_c1, im_c1].
    The htdemucs frequency branch flows in this layout."""
    B, C, Fq, T = z.shape
    stacked = torch.stack([z.real, z.imag], dim=2)     # (B, C, 2, F, T)
    return stacked.permute(0, 3, 1, 2, 4).reshape(B, Fq, 2 * C, T)


def spec_cac_fmajor(x: torch.Tensor, n_fft: int = FFT_WINDOW_SIZE,
                    hop: int = FFT_HOP_SIZE) -> torch.Tensor:
    """Demucs `_spec` + CaC pack, frequency-major: (B, C, L) f32
    -> (B, n_fft//2, 2C, ceil(L/hop)) f32."""
    return cac_pack_fmajor(spec(x, n_fft, hop))


def ispec_cac_fmajor(x: torch.Tensor, sources: int, length: int,
                     n_fft: int = FFT_WINDOW_SIZE, hop: int = FFT_HOP_SIZE,
                     bin_offset: int = 0) -> torch.Tensor:
    """Un-CaC + ispec for F-major spectra: (B, F, S*2C, T) -> (B, S, C, length).

    bin_offset > 0 means the bin axis is the decoder's untrimmed output,
    whose real bins are rows [bin_offset : bin_offset + n_fft//2].
    """
    if bin_offset:
        x = x[:, bin_offset:bin_offset + n_fft // 2]
    xs = x.transpose(1, 2)                             # (B, S*2C, F, T)
    xs = xs.reshape(xs.shape[0], sources, -1, *xs.shape[-2:])
    return ispec(cac_unpack(xs.float()), length, n_fft, hop)

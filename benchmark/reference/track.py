"""Plain whole-track separation: normalize, shift, split, overlap-add.

A frozen copy of the track conventions of `demucs_tpu_torch/pipeline.py`
(`Separator._normalize_shift`, `split_into_segments`, `triangle_weight`,
`overlap_add`), worked out again from the options the benchmark hands to
both sides: 25% overlap, triangular transition weights, the shift
offset drawn from `shift_seed`, the mono-reference mean and unbiased
std, the weighted sum in float64 (on the device). The model is the reference model, run
on `block` segments at a time with TF32 off (`f32_exact`), or with TF32
on where a control asks for the lower precision.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def f32_exact(tf32: bool = False):
    """TF32 off (or, for a control, on) for cuBLAS and cuDNN inside the
    block; the flags are put back after it."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = tf32
    try:
        yield
    finally:
        for f, was in zip(flags, saved):
            f.allow_tf32 = was


def triangle_weight(segment: int, power: float = 1.0) -> np.ndarray:
    half = segment // 2
    ramp = np.linspace(1, half, half, dtype=np.float64)
    w = np.concatenate([ramp, ramp[::-1]])
    if segment % 2:
        w = np.concatenate([w[:half], [half], w[half:]])
    w = w / w.max()
    return (w ** power).astype(np.float32)


def shift_offset(max_shift: int, shift_seed: int) -> int:
    if max_shift == 0:
        return 0
    return int(np.random.default_rng(shift_seed).integers(0, max_shift))


def prepare(audio: np.ndarray, opts: dict):
    """(C, N) -> (segments (n, C, seg), state for `finish`)."""
    N = audio.shape[-1]
    ref = audio.mean(0)
    mean, std = ref.mean(), ref.std(ddof=1)
    normalized = (audio - mean) / max(std, 1e-8)
    max_shift = int(opts["max_shift_secs"] * opts["sample_rate"])
    offset = shift_offset(max_shift, opts["shift_seed"])
    padded = np.zeros((audio.shape[0], N + 2 * max_shift), np.float32)
    padded[:, max_shift:max_shift + N] = normalized
    shifted = padded[:, offset:N + max_shift]
    seg = opts["segment_samples"]
    stride = int((1 - opts["overlap"]) * seg)
    offsets = list(range(0, shifted.shape[-1], stride))
    segs = np.zeros((len(offsets), audio.shape[0], seg), np.float32)
    meta = []
    for i, off in enumerate(offsets):
        chunk = shifted[:, off:off + seg]
        clen = chunk.shape[-1]
        left = (seg - clen) // 2
        segs[i, :, left:left + clen] = chunk
        meta.append((off, clen, left))
    return segs, (meta, shifted.shape[-1], max_shift, offset, N, mean, std)


def finish(chunks: torch.Tensor, state, opts: dict) -> np.ndarray:
    """(n, S, C, seg) stems of the segments, on any device -> (S, C, N)
    stems of the track: each segment's stems times the weight (in f32),
    summed in float64 on the segments' device."""
    meta, length, max_shift, offset, N, mean, std = state
    seg = opts["segment_samples"]
    dev = chunks.device
    weight = torch.from_numpy(triangle_weight(seg, opts["transition_power"])).to(dev)
    S, C = chunks.shape[1], chunks.shape[2]
    out = torch.zeros(S, C, length, dtype=torch.float64, device=dev)
    wsum = torch.zeros(length, dtype=torch.float64, device=dev)
    for (off, clen, left), chunk in zip(meta, chunks):
        end = min(off + clen, length)
        n = end - off
        out[:, :, off:end] += (weight[:n] * chunk[:, :, left:left + n]).double()
        wsum[off:end] += weight[:n].double()
    out = (out / wsum).float()[:, :, max_shift - offset:max_shift - offset + N]
    return out.cpu().numpy() * std + mean


def separate(model: torch.nn.Module, audio: np.ndarray, opts: dict, device,
             block: int = 2, tf32: bool = False) -> np.ndarray:
    """(C, N) -> (S, C, N) through the reference model, `block` segments
    a call."""
    segs, state = prepare(audio, opts)
    outs = []
    with torch.no_grad(), f32_exact(tf32):
        for i in range(0, len(segs), block):
            outs.append(model(torch.from_numpy(segs[i:i + block]).to(device)).float())
    return finish(torch.cat(outs), state, opts)

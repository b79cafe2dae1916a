"""Training data: segment sampling and augmentation.

The port of `demucs_tpu/data.py` (the upstream demucs trainer's data
path):

  * host side: random fixed-length segments from per-track stem arrays
    (the MUSDB layout: one (S, C, N) array per track), `SegmentSampler`,
    with numpy's `default_rng`, so that its batches are bit-identical to
    the JAX package's for one seed;
  * device side: channel flip, sign flip and gain per (batch, source),
    then Remix (each source's row drawn from a permutation of the
    batch). The JAX package draws inside its jitted step from a
    `jax.random` key; here the draws (`draw_augmentation`, from an
    explicit `torch.Generator`) are split from their deterministic
    application (`apply_augmentation`), so a test can feed the JAX
    package's draws to the port;
  * the mix is re-synthesized as the sum of the augmented stems;
  * K steps per call (`augmented_steps`): K batches stacked in one upload,
    their K losses fetched once.

Over several ranks (`tools/train_cli.py --num-processes`) every rank
samples the same global batch and draws the same augmentation from the
same seed, so Remix's permutations, which mix rows across the batch, are
the global batch's; `train.ShardedTrainStep` then takes the rank's dp
slice of the augmented batch, as the JAX package's sharded step does
inside its program.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .train import TrainStep
from .utils import profiling


SCALE_MIN, SCALE_MAX = 0.75, 1.25  # the gain's range, as in the JAX package


class Augmentation(NamedTuple):
    """The random draws of one augmentation of a (B, S, C, T) batch."""
    flip: torch.Tensor   # (B, S) bool: swap the stereo channels
    sign: torch.Tensor   # (B, S) +-1
    scale: torch.Tensor  # (B, S) gain
    perms: torch.Tensor | None  # (B, S) int64: batch row per source; None at B = 1


def draw_augmentation(shape, generator: torch.Generator) -> Augmentation:
    """Draws for a batch of `shape` (B, S, C, T), from `generator`, on its
    device. Remix whenever B > 1."""
    B, S = shape[:2]
    dev = generator.device
    flip = torch.rand(B, S, generator=generator, device=dev) < 0.5
    sign = torch.randint(0, 2, (B, S), generator=generator, device=dev) * 2 - 1
    scale = SCALE_MIN + (SCALE_MAX - SCALE_MIN) * torch.rand(
        B, S, generator=generator, device=dev)
    perms = None
    if B > 1:
        perms = torch.stack([torch.randperm(B, generator=generator, device=dev)
                             for _ in range(S)], dim=1)
    return Augmentation(flip, sign, scale, perms)


def apply_augmentation(stems: torch.Tensor, flip: torch.Tensor, sign: torch.Tensor,
                       scale: torch.Tensor, perms: torch.Tensor | None) -> torch.Tensor:
    """(B, S, C, T) -> (B, S, C, T): channel flip where `flip`, times
    `sign` and `scale`, then out[b, s] = in[perms[b, s], s] (Remix; skipped
    when `perms` is None), as `demucs_tpu.data.augment_stems` does."""
    stems = torch.where(flip[:, :, None, None], stems.flip(2), stems)
    stems = stems * (sign.to(stems.dtype) * scale.to(stems.dtype))[:, :, None, None]
    if perms is not None:
        index = perms[:, :, None, None].expand_as(stems)
        stems = torch.gather(stems, 0, index)
    return stems


def augment_stems(stems: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Draw from `generator` (on the stems' device), then apply:
    (B, S, C, T) -> (B, S, C, T)."""
    return apply_augmentation(stems, *draw_augmentation(stems.shape, generator))


def mix_from_stems(stems: torch.Tensor) -> torch.Tensor:
    """(B, S, C, T) -> (B, C, T): the self-consistent training mix."""
    return stems.sum(dim=1)


class SegmentSampler:
    """Random fixed-length segment batches from per-track stem arrays.

    tracks: list of (S, C, N) float32 arrays. Uniform over tracks, then
    uniform over valid offsets; deterministic per seed, and the same
    batches as `demucs_tpu.data.SegmentSampler` for the same seed.
    """

    def __init__(self, tracks: list[np.ndarray], segment_samples: int,
                 seed: int = 0):
        if not tracks:
            raise ValueError("no training tracks")
        self.tracks = [np.asarray(t, np.float32) for t in tracks]
        S, C = self.tracks[0].shape[:2]
        for t in self.tracks:
            if t.shape[:2] != (S, C):
                raise ValueError(f"inconsistent stem layout {t.shape[:2]} vs {(S, C)}")
            if t.shape[-1] < segment_samples:
                raise ValueError("track shorter than segment_samples")
        self.segment = segment_samples
        self._rng = np.random.default_rng(seed)

    def batch(self, batch_size: int) -> np.ndarray:
        """-> (B, S, C, segment) float32."""
        with profiling.span("data.sample", batch=batch_size):
            out = np.empty((batch_size,) + self.tracks[0].shape[:2] + (self.segment,),
                           np.float32)
            for b in range(batch_size):
                t = self.tracks[self._rng.integers(len(self.tracks))]
                off = self._rng.integers(t.shape[-1] - self.segment + 1)
                out[b] = t[:, :, off:off + self.segment]
            return out


def load_musdb_track(track_dir: str | Path,
                     stems=("drums", "bass", "other", "vocals")) -> np.ndarray:
    """MUSDB-layout track dir ({stem}.wav files) -> (S, C, N) float32."""
    from . import audio

    arrays = []
    for stem in stems:
        x, _ = audio.read_wav(Path(track_dir) / f"{stem}.wav")
        arrays.append(np.atleast_2d(x))
    n = min(a.shape[-1] for a in arrays)
    return np.stack([a[:, :n] for a in arrays])


def augmented_step(step: TrainStep, stems: torch.Tensor, aug: Augmentation) -> torch.Tensor:
    """One training step on stems (B, S, C, T) on the model's device,
    augmented by the draws `aug` (`draw_augmentation` on the stems'
    device), the mix being the sum of the augmented stems. The counterpart
    of the step of `make_augmented_train_step`; returns the loss."""
    with profiling.span("data.augment"):
        stems = apply_augmentation(stems, *aug)
        mix = mix_from_stems(stems)
    return step(mix, stems)


def augmented_steps(step: TrainStep, stems: torch.Tensor,
                    augs: list[Augmentation]) -> torch.Tensor:
    """K augmented training steps on the K batches stacked in stems (K, B,
    S, C, T), one upload, batch k augmented by `augs[k]`; returns the K
    losses as one (K,) tensor on the device (`TrainStep.steps`). The
    counterpart of the step of `make_augmented_multi_train_step`, and bit
    for bit K calls of `augmented_step`."""
    if len(augs) != stems.shape[0]:
        raise ValueError(f"{len(augs)} augmentations for {stems.shape[0]} batches")
    with profiling.span("data.augment"):
        stems = torch.stack([apply_augmentation(s, *aug) for s, aug in zip(stems, augs)])
        mixes = torch.stack([mix_from_stems(s) for s in stems])
    return step.steps(mixes, stems)

"""What the drivers share: device fences, the peak memory reading, freeing
the program's state, and the reference's stems of the kept songs.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from ..harness.core import Run
from ..harness.program import seeded_weights
from ..reference import track
from ..reference.models import meta_model


class Marks:
    """Seconds since t_start at each named step of a set-up, printed to
    standard error by `report`, which returns the total."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start
        self.steps: list = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.steps.append((name, now - self.last))
        self.last = now

    def report(self, what: str) -> float:
        total = time.perf_counter() - self.t_start
        parts = ", ".join(f"{n} {s:.2f}" for n, s in self.steps)
        print(f"portbench: {what} {total:.2f} s ({parts})", file=sys.stderr)
        return total


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def release(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_on(run: Run) -> torch.nn.Module:
    """The reference model of the run's configuration on its device,
    holding the seeded weights, drawn again."""
    model = meta_model(run.cfg)
    model.load_state_dict(seeded_weights(run.cfg, run.seed, run.device), strict=True,
                          assign=True)
    return model.to(run.device).eval()


class ReferenceCache:
    """The reference's stems of each kept song, computed once per precision
    (f32, or TF32 for the control) after the program's state is freed."""

    def __init__(self, run: Run):
        self.run = run
        self._model = None
        self._stems: dict = {}

    def stems(self, key, song, tf32: bool = False):
        if (key, tf32) not in self._stems:
            if self._model is None:
                self._model = reference_on(self.run)
            a = self.run.cfg["apply"]
            self._stems[key, tf32] = track.separate(self._model, song, a, self.run.device,
                                                    block=self.run.cfg["reference_block"],
                                                    tf32=tf32)
        return self._stems[key, tf32]

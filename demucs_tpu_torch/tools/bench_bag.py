"""Fine-tuned bag throughput: `BagOfModels` in one call against four
sequential single-model calls.

The port of `demucs_tpu/tools/bench_bag.py`. Four htdemucs-4s models
(random weights, seeds 0-3) separate one batch: as `models/bag.py:
BagOfModels` in one call (model i run and its stem i kept, the form the
CLI's `--ft-dir` runs; the JAX tool's "vmap" strategy), and as four calls
of single models each keeping its whole output ("sequential4"). On the
card: batch `--batch` of the full 343980-sample segment in the port's
f32 network (the JAX tool picks bf16 on a TPU); on the CPU batch 1 of
65536 samples, as the JAX tool's CPU branch. Each strategy is timed as
the best of two windows of `--iters` calls, each window ending in one
fetch of the last call's sum.

Usage: python -m demucs_tpu_torch.tools.bench_bag [--iters 6] [--batch 8]
           [--device cuda|cpu]
Prints one JSON line per strategy (the card's name and power limit in
"device").
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# the JAX tool's CPU branch: batch 1 of this many samples
CPU_SEGMENT_SAMPLES = 65536


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..config import SAMPLE_RATE, SEGMENT_SAMPLES
    from ..models import BagOfModels
    from ..utils.device import resolve_device
    from . import card_line, segment_model

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    batch = args.batch if cuda else 1
    seg = SEGMENT_SAMPLES if cuda else CPU_SEGMENT_SAMPLES
    card = card_line(device)
    models = [segment_model("htdemucs_4s", device=device, seed=s) for s in range(4)]
    bag = BagOfModels(models)
    gen = torch.Generator(device=device).manual_seed(0)
    mix = 0.1 * torch.randn(batch, 2, seg, device=device, generator=gen)
    audio_s = batch * seg / SAMPLE_RATE

    def timed(fn):
        with torch.inference_mode():
            fn().item()
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    out = fn()
                out.item()
                best = min(best, (time.perf_counter() - t0) / args.iters)
        return best

    # 1) the bag in one call (the JAX tool's vmapped program)
    dt = timed(lambda: bag(mix).sum())
    print(json.dumps({"strategy": "vmap", "step_s": round(dt, 4),
                      "audio_s_per_s": round(audio_s / dt, 1),
                      "note": "BagOfModels in one call (no vmap here)", "device": card}))

    # 2) four sequential single-model calls on the same batch
    def seq():
        for model in models:
            out = model(mix).sum()
        return out

    dt = timed(seq)
    print(json.dumps({"strategy": "sequential4", "step_s": round(dt, 4),
                      "audio_s_per_s": round(audio_s / dt, 1),
                      "note": "time for all four models on the same batch", "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

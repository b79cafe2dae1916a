"""Throughput sweep across batch sizes, dtypes and weight formats.

The port of `demucs_tpu/tools/bench_sweep.py`: the segment graph of
htdemucs-4s (hdemucs_mmi with `--v3`, random weights from seed 0) at each
batch of `--batches`, network of `--dtypes` (bf16: the port's `--bf16`)
and weight format of `--quant` (int8 / fp8: the CLI's, whose network
stays f32, the weights widening to bf16 with bf16). One JSON line per
configuration: the step time over `--iters` calls, ending in one fetch,
after a first call (`compile_s`: its time, cuDNN's plans and the
kernels' build included when they are not built yet).

    python -m demucs_tpu_torch.tools.bench_sweep [--batches 4 8 16] \\
        [--dtypes bf16 f32] [--quant none int8 fp8] [--iters 10] [--v3]
    python -m demucs_tpu_torch.tools.bench_sweep --family > family.json

`--family` prints one JSON object measuring every family at the JAX
tool's configuration: htdemucs-4s, htdemucs-6s and hdemucs_mmi in bf16
at the first of `--batches` (default 8), the fine-tuned bag's two forms
(four sequential calls of one model; `BagOfModels` of it four times in
one call) and an htdemucs-4s training step (batch 2, no remat, bf16
compute, f32 master weights); the keys are the JAX report's. The JAX
tool stretches `--iters` to 128 / batch at the full segment to amortize
a TPU host's ~37 ms fence; a CUDA synchronize costs microseconds, so
here `--iters` is the count. The card's name and power limit stand in
"device" beside the numbers. The segment is the full 343980 samples
unless `--segment-samples` (for tests) says otherwise. Default device:
cuda.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _measure(fn, iters: int, audio_s: float) -> dict:
    """fn() once (its time: compile_s), then `iters` timed calls ending
    in one fetch."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        fn().item()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        out.item()
    dt = (time.perf_counter() - t0) / iters
    return {"step_s": round(dt, 4), "audio_s_per_s": round(audio_s / dt, 1),
            "compile_s": round(first_s, 1)}


def family_bench(batch: int = 1, iters: int = 8, train_batch: int = 2,
                 seg: int | None = None, device: str | torch.device = "cuda") -> dict:
    """Every model family at the JAX tool's configuration (bf16) plus a
    training step, as one dict (the module docstring)."""
    from ..config import SAMPLE_RATE, SEGMENT_SAMPLES
    from ..models import BagOfModels, build_model
    from ..train import TrainStep
    from ..utils.device import resolve_device
    from . import card_line, family, segment_model, state_dict

    device = resolve_device(device)
    seg = seg or SEGMENT_SAMPLES
    gen = torch.Generator(device=device).manual_seed(0)
    mix = 0.1 * torch.randn(batch, 2, seg, device=device, generator=gen)
    audio_s = batch * seg / SAMPLE_RATE
    report = {"batch": batch, "iters": iters, "segment_samples": seg,
              "device": card_line(device)}

    for name in ("htdemucs_4s", "htdemucs_6s", "hdemucs_v3"):
        model = segment_model(name, "bf16", device=device)
        report[name] = _measure(lambda: model(mix).float().sum(), iters, audio_s)
        print(f"{name}: {report[name]}", file=sys.stderr)
        if name == "htdemucs_4s":
            model4 = model
        else:
            del model

    # the bag's sequential form: one model called four times (ideal = rate / 4)
    def seq():
        for _ in range(4):
            out = model4(mix).float().sum()
        return out

    report["ft_bag_sequential4"] = _measure(seq, iters, audio_s)
    print(f"ft_bag_sequential4: {report['ft_bag_sequential4']}", file=sys.stderr)
    bag = BagOfModels([model4] * 4)
    report["ft_bag_unrolled"] = _measure(lambda: bag(mix).float().sum(), iters, audio_s)
    print(f"ft_bag_unrolled: {report['ft_bag_unrolled']}", file=sys.stderr)
    del bag, model4

    # a training step: full htdemucs-4s, no remat, bf16 compute, f32 master weights
    cfg = family("htdemucs_4s")[0]
    step = TrainStep(build_model(cfg, state_dict("htdemucs_4s")[0], device, train=True),
                     compute_dtype=torch.bfloat16)
    mixt = 0.1 * torch.randn(train_batch, 2, seg, device=device, generator=gen)
    refs = 0.05 * torch.randn(train_batch, cfg.num_sources, 2, seg, device=device,
                              generator=gen)
    step(mixt, refs).item()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(mixt, refs)
    loss.item()
    dt = (time.perf_counter() - t0) / iters
    report["train_step"] = {"batch": train_batch, "remat": False, "compute_dtype": "bf16",
                            "step_s": round(dt, 4),
                            "audio_s_per_s": round(train_batch * seg / SAMPLE_RATE / dt, 1)}
    print(f"train_step: {report['train_step']}", file=sys.stderr)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="throughput sweep")
    ap.add_argument("--batches", type=int, nargs="+", default=[8])
    ap.add_argument("--dtypes", nargs="+", default=["bf16"], choices=["bf16", "f32"])
    ap.add_argument("--quant", nargs="+", default=["none"], choices=["none", "int8", "fp8"],
                    help="weight storage format (weight-only quant)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--v3", action="store_true")
    ap.add_argument("--family", action="store_true",
                    help="benchmark EVERY model family + a train step; print one JSON object")
    ap.add_argument("--segment-samples", type=int, default=None,
                    help=argparse.SUPPRESS)  # testing
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..config import SAMPLE_RATE, SEGMENT_SAMPLES
    from ..utils.device import resolve_device
    from . import card_line, segment_model

    device = resolve_device(args.device)
    if args.family:
        print(json.dumps(family_bench(batch=args.batches[0], iters=args.iters,
                                      seg=args.segment_samples, device=device)))
        return 0

    name = "hdemucs_v3" if args.v3 else "htdemucs_4s"
    seg = args.segment_samples or SEGMENT_SAMPLES
    card = card_line(device)
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype_name in args.dtypes:
        for quant_name in args.quant:
            model = segment_model(name, dtype_name, quant_name, device)
            for batch in args.batches:
                mix = 0.1 * torch.randn(batch, 2, seg, device=device, generator=gen)
                rec = _measure(lambda: model(mix).float().sum(), args.iters,
                               batch * seg / SAMPLE_RATE)
                print(json.dumps({"model": "hdemucs_mmi" if args.v3 else "htdemucs_4s",
                                  "batch": batch, "dtype": dtype_name, "quant": quant_name,
                                  **rec, "segment_samples": seg, "device": card}), flush=True)
            del model
    return 0


if __name__ == "__main__":
    sys.exit(main())

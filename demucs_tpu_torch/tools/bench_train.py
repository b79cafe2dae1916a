"""Training-step sweep: batch x remat policy x compute dtype x steps per call.

The port of `demucs_tpu/tools/bench_train.py`. For each family and each
configuration it builds a fresh trainable model (random weights from
seed 0, f32 master weights), takes warm-up steps, then times `--iters`
calls; one JSON line per configuration:

    python -m demucs_tpu_torch.tools.bench_train --batches 2 4
    python -m demucs_tpu_torch.tools.bench_train --batches 4 \\
        --remat off dots none dots_nb --dtypes f32 bf16
    python -m demucs_tpu_torch.tools.bench_train --v3      # or --family hdemucs_v3
    python -m demucs_tpu_torch.tools.bench_train --families htdemucs_4s hdemucs_v3 \\
        --steps-per-call 1 2

It takes the JAX tool's command line: `--family` (or `--v3`, shorthand
for hdemucs_v3) picks one family, and `--remat` defaults to `dots`, so a
JAX command line measures the same configuration here; `--families`
sweeps several families in one run.

Each line holds the step time (host clock over the timed calls, which
end in one fetch of the last loss; a step's launches are asynchronous,
so the fetch is the fence), the audio-seconds trained per second, the
peak device memory of the timed calls (`torch.cuda.max_memory_allocated`),
the device's busy share of one more call under `torch.profiler` (its
kernels' device time over the call's wall, the profiler's own overhead
in that wall) and the card (`nvidia-smi`'s name and power limit); with
`--top N`, also that call's device time, its number of device events,
and its N largest kernels by device time and host ops by their own host
time (name, ms, calls), which say where a configuration's time goes. A
configuration that runs out of device memory is recorded as {"oom":
true} instead of ending the sweep (that boundary is itself the
measurement). It runs on cuda unless `--device cpu` is given; without a
GPU a CUDA run fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

FAMILIES = ("htdemucs_4s", "htdemucs_6s", "hdemucs_v3")


def bench_one(family: str, batch: int, seg: int, remat: str, dtype_name: str,
              iters: int, steps_per_call: int, device: torch.device,
              lr: float = 3e-4, top: int = 0) -> dict:
    from ..config import SAMPLE_RATE
    from ..models import build_model
    from ..train import TrainStep
    from . import family as family_of, state_dict

    cfg = family_of(family)[0]
    model = build_model(cfg, state_dict(family)[0], device, train=True)
    step = TrainStep(model, lr=lr, remat=remat != "off",
                     remat_policy=remat if remat != "off" else "dots",
                     compute_dtype=torch.bfloat16 if dtype_name == "bf16" else None)
    gen = torch.Generator(device=device).manual_seed(0)
    K = steps_per_call
    mixes = 0.1 * torch.randn(K, batch, 2, seg, device=device, generator=gen)
    refss = 0.05 * torch.randn(K, batch, cfg.num_sources, 2, seg, device=device,
                               generator=gen)
    cuda = device.type == "cuda"

    t0 = time.perf_counter()
    step.steps(mixes, refss)[-1].item()  # the first call: allocations, cuDNN plans
    first_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        losses = step.steps(mixes, refss)
    losses[-1].item()  # fences the whole chain
    dt = (time.perf_counter() - t0) / (iters * K)
    rec = {"step_s": dt, "audio_s_per_s": batch * seg / SAMPLE_RATE / dt,
           "first_call_s": first_s}
    if cuda:
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        rec.update(_profiled(lambda: step.steps(mixes, refss)[-1].item(), top))
    return rec


def _profiled(call, top: int = 0) -> dict:
    """One `call` under torch.profiler: the device's busy share (the
    device time of its kernels and copies over its wall time; None if the
    profiler recorded no device time) and, if `top`, the device time, the
    number of device events, and the `top` largest kernels by device time
    and host ops by self host time, each [name, ms, calls]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if not getattr(e, "is_user_annotation", False)]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    rec = {"busy_share": device_us / 1e6 / wall if device_us else None}
    if top:
        host = [e for e in events if e.device_type == DeviceType.CPU]
        rows = lambda es, us: [[e.key[:120], us(e) / 1e3, e.count]  # noqa: E731
                               for e in sorted(es, key=us, reverse=True)[:top]]
        rec.update(profile_wall_s=wall, device_s=device_us / 1e6,
                   device_events=sum(e.count for e in device),
                   top_kernels=rows(device, lambda e: e.self_device_time_total),
                   top_host_ops=rows(host, lambda e: e.self_cpu_time_total))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="training-step sweep")
    ap.add_argument("--family", choices=FAMILIES, default=None,
                    help="model family (--v3 is shorthand for hdemucs_v3)")
    ap.add_argument("--v3", action="store_true")
    ap.add_argument("--families", nargs="+", choices=FAMILIES, default=None,
                    help="several families in one run (in place of --family)")
    ap.add_argument("--batches", type=int, nargs="+", default=[2])
    ap.add_argument("--remat", nargs="+", default=["dots"],
                    choices=["off", "dots", "none", "dots_nb"])
    ap.add_argument("--dtypes", nargs="+", default=["f32"], choices=["f32", "bf16"])
    ap.add_argument("--steps-per-call", type=int, nargs="+", default=[1],
                    help="optimizer steps per call (TrainStep.steps)")
    ap.add_argument("--iters", type=int, default=6, help="timed calls per configuration")
    ap.add_argument("--segment-samples", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--top", type=int, default=0,
                    help="also report the profiled call's N largest kernels and host ops")
    args = ap.parse_args(argv)

    from ..config import SEGMENT_SAMPLES
    from ..utils.device import resolve_device
    from . import card_line

    device = resolve_device(args.device)
    card = card_line(device)
    seg = args.segment_samples or SEGMENT_SAMPLES
    families = args.families or [args.family or ("hdemucs_v3" if args.v3 else "htdemucs_4s")]
    for family in families:
        for dtype_name in args.dtypes:
            for remat in args.remat:
                for K in args.steps_per_call:
                    for batch in args.batches:
                        rec = {"model": "hdemucs_mmi" if family == "hdemucs_v3" else family,
                               "batch": batch, "remat": remat, "compute_dtype": dtype_name,
                               "steps_per_call": K, "segment_samples": seg,
                               "device": card}
                        try:
                            rec.update(bench_one(family, batch, seg, remat, dtype_name,
                                                 args.iters, K, device, top=args.top))
                        except torch.cuda.OutOfMemoryError as e:
                            rec.update({"oom": True, "error": str(e).splitlines()[0][:200]})
                        if device.type == "cuda":
                            torch.cuda.empty_cache()
                        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

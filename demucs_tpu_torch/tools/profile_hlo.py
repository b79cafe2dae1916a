"""Per-kernel device profile of the segment step (or a training step).

The port of `demucs_tpu/tools/profile_hlo.py`. There is no HLO here: the
name is kept so that a reader finds the counterpart. It runs
`torch.profiler` over `--steps` warm calls of the segment graph of
htdemucs-4s (hdemucs_mmi with `--v3`) and sums the device time of each
CUDA kernel and copy by its name: the device time per step, the largest
kernels by self time (`top_ops_ms`), and a grouping into classes
(`buckets_ms`: attention (K1), dconv (K5), convolution, fft, ...;
`utils.profiling.kernel_class`), the keys of the JAX tool's
`group_report`.

Usage:
    python -m demucs_tpu_torch.tools.profile_hlo [--v3] [--int8 | --fp8]
        [--steps 6] [--batch 8] [--train [--train-remat dots] [--train-bf16]]
        [--out report.json] [--trace-dir DIR] [--device cuda|cpu]

What it measures: on the card, batch `--batch` of the full 343980-sample
segment in the port's f32 network (the JAX tool picks bf16 on a TPU; the
port's default network is f32), random weights from seed 0; `--int8` /
`--fp8` the CLI's weights; `--train` one training step of f32 master
weights (`--train-bf16`: bf16 compute) with the remat policy
`--train-remat` ("off": none). On the CPU, batch 1 of 65536 samples, as
the JAX tool's CPU branch, where the profiler records no device time.
The first call is untimed; then `--steps` calls are timed on the host
clock (one fence at the end: `wall_ms_per_step`), then `--steps` more
are profiled. It writes the report to `--out` and a Chrome trace
(`trace.json`) into `--trace-dir`, and prints the step's wall and
device times as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time
from pathlib import Path

import torch

# the JAX tool's CPU branch: batch 1 of this many samples
CPU_SEGMENT_SAMPLES = 65536


def group_report(per_kernel_us: dict, steps: int, top: int = 40) -> dict:
    """{kernel name: device us over `steps` steps} -> ms per step in all
    (None where no device time was recorded, as on the CPU), by class and
    for the `top` largest kernels."""
    from ..utils.profiling import kernel_class

    per_bucket = collections.Counter()
    for name, us in per_kernel_us.items():
        per_bucket[kernel_class(name)] += us
    total_ms = sum(per_kernel_us.values()) / 1e3 / steps
    kernels = sorted(per_kernel_us.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ms_per_step": round(total_ms, 3) if per_kernel_us else None,
        "buckets_ms": {k: round(v / 1e3 / steps, 3) for k, v in per_bucket.most_common(25)},
        "top_ops_ms": [{"op": k, "ms": round(v / 1e3 / steps, 4)} for k, v in kernels],
    }


def device_kernel_us(prof) -> dict:
    """{kernel or copy name: its self device time in us} of a finished
    torch.profiler run (user annotations left out: their spans cover
    kernels listed on their own)."""
    from torch.autograd import DeviceType

    out: dict[str, float] = collections.Counter()
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            out[e.key] += e.self_device_time_total
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--v3", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--fp8", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="profile one TRAINING step (fwd+bwd+Adam) instead of inference")
    ap.add_argument("--train-remat", default="dots", choices=["off", "dots", "none", "dots_nb"])
    ap.add_argument("--train-bf16", action="store_true",
                    help="bf16 compute, f32 master weights")
    tmp = Path(tempfile.gettempdir())
    ap.add_argument("--out", default=str(tmp / "hlo_profile.json"))
    ap.add_argument("--trace-dir", default=str(tmp / "demucs_tpu_torch_trace"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from ..config import SEGMENT_SAMPLES
    from ..utils.device import resolve_device
    from . import card_line, family, segment_model, state_dict

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    name = "hdemucs_v3" if args.v3 else "htdemucs_4s"
    quant = "int8" if args.int8 else "fp8" if args.fp8 else "none"
    batch = args.batch if cuda else 1
    seg = SEGMENT_SAMPLES if cuda else CPU_SEGMENT_SAMPLES
    gen = torch.Generator(device=device).manual_seed(0)
    mix = 0.1 * torch.randn(batch, 2, seg, device=device, generator=gen)

    if args.train:
        from ..models import build_model
        from ..train import TrainStep

        cfg = family(name)[0]
        step = TrainStep(build_model(cfg, state_dict(name)[0], device, train=True),
                         remat=args.train_remat != "off",
                         remat_policy=args.train_remat if args.train_remat != "off" else "dots",
                         compute_dtype=torch.bfloat16 if args.train_bf16 else None)
        refs = 0.05 * torch.randn(batch, cfg.num_sources, 2, seg, device=device, generator=gen)
        call = lambda: step(mix, refs)  # noqa: E731
    else:
        model = segment_model(name, "f32", quant, device)

        def call():
            with torch.inference_mode():
                return model(mix).float().sum()

    t0 = time.perf_counter()
    call().item()
    print(f"# first call: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = call()
    out.item()  # one fence for the whole window
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"# wall: {wall_ms:.1f} ms/step", flush=True)

    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            out = call()
        out.item()
    prof.export_chrome_trace(str(trace_dir / "trace.json"))

    rep = group_report(device_kernel_us(prof), args.steps)
    rep["wall_ms_per_step"] = round(wall_ms, 2)
    rep["config"] = {"v3": args.v3, "int8": args.int8, "fp8": args.fp8, "batch": batch,
                     "segment": seg, "train": args.train,
                     "train_remat": args.train_remat if args.train else None,
                     "train_bf16": args.train_bf16 if args.train else None}
    rep["device"] = card_line(device)
    Path(args.out).write_text(json.dumps(rep, indent=1))
    print(json.dumps({k: rep[k] for k in ("wall_ms_per_step", "device_ms_per_step")}))
    print("# full report:", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

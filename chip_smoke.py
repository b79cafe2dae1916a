#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (demucs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the package from csrc/ with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version at every shape
     the main path gives it, and time kernel, plain version and the
     PyTorch library call with CUDA events;
  4. the main path: htdemucs-4s at full width (random weights from seed
     0, written as a ggml file) separates a ~20 s synthetic stereo WAV
     through the port's CLI on the GPU; the stems must be finite, of the
     track's length, and every kernel must have launched on that run;
     the same separation again in-process, timed warm, and once more
     under torch.profiler (device time by layer, busy share);
  5. a reference check: the same model on the GPU and on the CPU (plain
     attention) agree on a short segment;
  6. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_CUDA_CORE = 67e12      # FLOP/s, f32 outside the tensor cores
PEAK_BF16_TENSOR = 989e12       # FLOP/s, bf16 tensor cores
PEAK_HBM = 3.35e12              # bytes/s

TRACK_SECS = 20.0
MAIN_BATCH = 2                  # segments per device call on the main path
ATTN_SHAPES = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))
HEADS = 8
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # max|kernel - plain| / max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(B, T, S, D, dtype) -> tuple[float, str]:
    """Least time for the work: flops over the peak of the operand type
    vs q, k, v, o read/written once over the memory rate."""
    import torch

    flops = 4.0 * B * HEADS * T * S * D
    peak = PEAK_F32_CUDA_CORE if dtype == torch.float32 else PEAK_BF16_TENSOR
    nbytes = 2.0 * B * HEADS * (T + S) * D * torch.tensor([], dtype=dtype).element_size()
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_attention():
    """Hold flash_mha against flash_mha_plain at every main-path shape."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.ops.cuda import flash_mha, flash_mha_plain
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    log("flash_mha vs flash_mha_plain, tolerance max|kernel - plain| <= "
        + ", ".join(f"{v:g} ({k})" for k, v in TOL.items()) + " x max|plain|")
    log(f"{'dtype':>8} {'B':>2} {'T':>5} {'S':>5} {'D':>3} {'err/scale':>10} "
        f"{'ms':>8} {'plain_ms':>9} {'sdpa_ms':>8} {'bound_ms':>9}")
    with torch.inference_mode(), f32_precision():
        for dtype in (torch.float32, torch.bfloat16):
            for D in (64, 48):
                for B in (1, 2):
                    for T, S in ATTN_SHAPES:
                        def rand(n):
                            return torch.randn(B, HEADS, n, D, device="cuda",
                                               generator=gen).to(dtype)
                        q, k, v = rand(T), rand(S), rand(S)
                        out = flash_mha(q, k, v)
                        ref = flash_mha_plain(q, k, v)
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs().max().item()
                        scale = ref.float().abs().max().item()
                        name = str(dtype).split(".")[-1]
                        if not (err <= TOL[name] * scale):
                            raise AssertionError(
                                f"flash_mha disagrees with plain at {name} "
                                f"B={B} T={T} S={S} D={D}: {err} > {TOL[name]} * {scale}")
                        ms = time_ms(lambda: flash_mha(q, k, v), 10)
                        plain_ms = time_ms(lambda: flash_mha_plain(q, k, v), 5)
                        lib_ms = time_ms(
                            lambda: F.scaled_dot_product_attention(q, k, v), 10)
                        bound, bound_by = attention_bound_ms(B, T, S, D, dtype)
                        rows.append(dict(dtype=name, B=B, T=T, S=S, D=D, err=err,
                                         rel_err=err / scale, ms=ms,
                                         plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=bound, bound_by=bound_by))
                        log(f"{name:>8} {B:>2} {T:>5} {S:>5} {D:>3} {err / scale:>10.2e} "
                            f"{ms:>8.3f} {plain_ms:>9.3f} {lib_ms:>8.3f} {bound:>9.4f}")
    return rows


def phase_main_path(card: str):
    """htdemucs-4s through the port's CLI on the GPU; returns
    (launch counts, number of segment batches, summary)."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import HTDEMUCS_4S, SAMPLE_RATE
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.models import build_htdemucs
    from demucs_tpu_torch.params import (htdemucs_schema, init_flat,
                                         load_model_params, write_ggml)
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator

    cfg = HTDEMUCS_4S
    n = int(TRACK_SECS * SAMPLE_RATE)
    offset = 1337
    opts = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=offset)
    shifted = n + int(opts.max_shift_secs * SAMPLE_RATE) - offset
    n_segments = math.ceil(shifted / int((1 - opts.overlap) * opts.segment_samples))
    n_batches = math.ceil(n_segments / MAIN_BATCH)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model_path = tmp / "htdemucs_4s.bin"
        write_ggml(model_path, "htdemucs_4s", init_flat(htdemucs_schema(cfg), seed=0))
        rng = np.random.default_rng(0)
        t = np.arange(n) / SAMPLE_RATE
        tones = np.stack([np.sin(2 * np.pi * 220.0 * t), np.sin(2 * np.pi * 331.0 * t)])
        wav = (0.3 * tones + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
        wav_path = tmp / "mix.wav"
        audio.write_wav(wav_path, wav)
        outdir = tmp / "stems"

        for kernel in KERNELS:
            kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main([str(model_path), str(wav_path), str(outdir),
                       "--device", "cuda", "--batch", str(MAIN_BATCH),
                       "--offset", str(offset)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        peak_mem = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"cli.main exited {rc}")

        for i, name in enumerate(cfg.sources):
            stem, rate = audio.read_wav(outdir / f"target_{i}_{name}.wav")
            if rate != SAMPLE_RATE or stem.shape != (2, n) or not np.isfinite(stem).all():
                raise AssertionError(f"stem {name}: rate {rate}, shape {stem.shape}, "
                                     f"finite {np.isfinite(stem).all()}")

        # the same work again in this process, timed by part: the CLI run
        # above also pays the process's one-time set-up costs
        t0 = time.monotonic()
        model = build_htdemucs(*load_model_params(model_path), "cuda")
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        sep = Separator(model, cfg.num_sources, opts, "cuda")
        track = audio.load_track(wav_path)
        t0 = time.monotonic()
        sep(track)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        profile = profile_separation(sep, track)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    expected = cfg.t_layers * 2 * n_batches
    if launches["flash_mha"] != expected:
        raise AssertionError(f"flash_mha launched {launches['flash_mha']} times, "
                             f"want {expected} (10 per segment batch x {n_batches})")
    summary = dict(track_secs=TRACK_SECS, segments=n_segments, batches=n_batches,
                   batch=MAIN_BATCH, wall_s=wall, audio_s_per_s=TRACK_SECS / wall,
                   max_memory_allocated=peak_mem, warm_load_s=load_s,
                   warm_separate_s=warm_s, warm_audio_s_per_s=TRACK_SECS / warm_s,
                   profile=profile, card=card)
    log(f"main path: {TRACK_SECS} s track, {n_segments} segments in {n_batches} "
        f"batches of {MAIN_BATCH}: CLI wall {wall:.3f} s, {TRACK_SECS / wall:.3f} "
        f"audio-s/s, max_memory_allocated {peak_mem} B, launches {launches}; "
        f"again in-process: load {load_s:.3f} s, separate {warm_s:.3f} s, "
        f"{TRACK_SECS / warm_s:.3f} audio-s/s [{card}]")
    return launches, n_batches, summary


# kernel-name fragments -> layer of the segment graph, first match wins
KERNEL_CLASSES = (
    ("attention (K1)", ("mha_fwd_kernel",)),
    # cuDNN's implicit-GEMM convolutions are named fprop/dgrad, cuBLAS's
    # products gemm; both are "xmma" kernels
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn")),
    ("fft", ("fft",)),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("reduction", ("reduce", "norm")),
    ("copy", ("copy", "memcpy", "memset", "cat", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_separation(sep, track) -> dict:
    """One more warm separation under torch.profiler: device time by
    layer, the largest kernels, and the device's busy share of the wall
    time (the profiler's own overhead is in that wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        sep(track)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    # device-side events only: a host op's self device time is that of
    # the kernels it launched, which are listed themselves
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in kernels)
    if not device_ms:
        log("profile: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    by_class: dict[str, float] = {}
    for key, ms, _ in kernels:
        name = key.lower()
        cls = next((c for c, frags in KERNEL_CLASSES if any(f in name for f in frags)),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    n_kernels = sum(count for _, _, count in kernels)
    log(f"profile of one warm separation: {n_kernels} device kernels and copies, "
        f"device {device_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"({device_ms / wall_ms:.1%} busy)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {cls:>15} {ms:9.2f} ms  {ms / device_ms:6.1%}")
    for key, ms, count in top:
        log(f"  {ms:9.2f} ms  x{count:<5} {key[:100]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_kernels=n_kernels,
                busy_share=device_ms / wall_ms, by_class_ms=by_class,
                top_kernels=[dict(name=k[:100], ms=ms, count=c) for k, ms, c in top])


def phase_reference():
    """The same htdemucs-4s on the GPU (CUDA kernel) and the CPU (plain
    attention) must agree on a short segment."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import HTDEMUCS_4S
    from demucs_tpu_torch.models import build_htdemucs
    from demucs_tpu_torch.params import from_state_dict, htdemucs_schema, init_flat

    cfg = HTDEMUCS_4S
    schema = htdemucs_schema(cfg)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_htdemucs(cfg, sd, device)
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    scale = float(np.abs(outs["cpu"]).max())
    if not (np.isfinite(outs["cuda"]).all() and diff < 3e-4 * max(scale, 1.0)):
        raise AssertionError(f"GPU vs CPU htdemucs: max diff {diff}, scale {scale}")
    log(f"reference: htdemucs-4s (1, 2, 32768) GPU vs CPU max|diff| {diff:.3e} "
        f"(scale {scale:.3e}, tolerance 3e-4 * max(scale, 1))")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from demucs_tpu_torch.ops.cuda import build, flash_attention

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    secs = build.build([flash_attention.SOURCE], force=True)
    log(f"built kernels from csrc/ in {secs:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    rows = phase_attention()
    launches, n_batches, summary = phase_main_path(card)
    phase_reference()

    # the kernels line: the main path's largest call (freq self-attention,
    # f32, D=64, at the main path's batch), with the error over all its
    # main-path shapes
    main_rows = [r for r in rows
                 if r["dtype"] == "float32" and r["D"] == 64 and r["B"] == MAIN_BATCH]
    head = next(r for r in main_rows if r["T"] == r["S"] == 2688)
    kernels = [{
        "name": "flash_mha", "route": "cuda",
        "source": "demucs_tpu_torch/csrc/flash_mha.cu",
        "replaces": "demucs_tpu/ops/pallas/attention.py:90",
        "launches": launches["flash_mha"],
        "max_abs_err": max(r["err"] for r in main_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"q,k,v ({MAIN_BATCH},{HEADS},2688,64) float32",
        "launches_per_segment_batch": launches["flash_mha"] / n_batches,
    }]
    log(json.dumps({"main_path": summary}))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

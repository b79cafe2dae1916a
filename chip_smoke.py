#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (demucs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the package from csrc/ with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version at every shape
     its path gives it, and time kernel, plain version and the PyTorch
     library call with CUDA events: K1 (inference forward) at the
     inference shapes, K2 (training forward with lse) and K3 (fused
     backward) at the training shapes;
  4. inference: htdemucs-4s at full width (random weights from seed 0,
     written as a ggml file) separates a ~20 s synthetic stereo WAV
     through the port's CLI on the GPU; the stems must be finite, of the
     track's length, K1 must launch 10 times per segment batch and K2,
     K3 never; the same separation again in-process, timed warm, and
     once more under torch.profiler (device time by layer, busy share);
  5. training: full-width htdemucs-4s through the port's training CLI,
     in-process (synthetic stems, EMA, checkpoints, ggml export), then
     resumed for 2 more steps; every loss finite, K2 and K3 10 launches
     per step and K1 none; the exported ggml separates a short track
     through the inference CLI; warm step time, audio-s trained per s,
     peak memory, and one step under torch.profiler;
  6. reference checks: the same model on the GPU and on the CPU (plain
     attention) agree on a short segment, in inference and in one
     training step (loss and every parameter's gradient);
  7. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
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
MAIN_BATCH = 2                  # segments per device call on the inference path
# (T, S) of the crosstransformer's 10 calls per segment: freq self, time
# self, freq-to-time cross, time-to-freq cross (5 layers x 2 branches)
ATTN_SHAPES = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))
HEADS = 8
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # max|kernel - plain| / max|plain|
# K2's lse is f32 on both sides, from the same operands, in either dtype
TOL_LSE = 1e-5                  # of max|plain lse|, plus as much absolute
# K3's gradients sum over one more axis than the forward, dq with atomics
# in an order that changes between runs
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_BATCH = 4                 # segments per training step
TRAIN_STEPS, RESUME_STEPS = 4, 6
# GPU against CPU, one training step: each parameter's gradient to 1e-3
# of its own norm (the forward alone agrees to ~5e-5 of scale), the loss
# to 1e-5 relative
TRAIN_REF_GRAD_TOL, TRAIN_REF_LOSS_TOL = 1e-3, 1e-5


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


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time for the work: flops over the peak of the operand type
    vs the bytes moved once over the memory rate."""
    import torch

    peak = PEAK_F32_CUDA_CORE if dtype == torch.float32 else PEAK_BF16_TENSOR
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_bound_ms(B, T, S, D, dtype, kind: str = "K1") -> tuple[float, str]:
    """K1: 4 BHTSD flops, q, k, v read and o written once; K2: the same
    plus lse (B, H, T) f32 written; K3: 10 BHTSD flops (five products),
    q, k, v, o, lse, dO read and dq, dk, dv written once."""
    import torch

    BH, e = B * HEADS, torch.tensor([], dtype=dtype).element_size()
    if kind == "K3":
        return bound_ms(10.0 * BH * T * S * D,
                        e * BH * D * (4 * T + 4 * S) + 4.0 * BH * T, dtype)
    lse_bytes = 4.0 * BH * T if kind == "K2" else 0.0
    return bound_ms(4.0 * BH * T * S * D, 2.0 * BH * (T + S) * D * e + lse_bytes, dtype)


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


def _err(out, ref) -> tuple[float, float]:
    """(max|out - ref|, max|ref|) in f32."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def phase_training_kernels():
    """Hold K2 (flash_mha_fwd: out, lse) and K3 (flash_mha_bwd: dq, dk,
    dv) against their plain twins at every training shape, and time
    each with its twin and the library call: SDPA's forward for K2, the
    gradient through SDPA's output (forward excluded) for K3."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.ops.cuda import (flash_mha_bwd, flash_mha_bwd_plain,
                                           flash_mha_fwd, flash_mha_fwd_plain)
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    log("flash_mha_fwd (K2) and flash_mha_bwd (K3) vs their plain twins, tolerance "
        "max|kernel - plain| <= " + ", ".join(f"{v:g} ({k})" for k, v in TOL.items())
        + f" x max|plain| for out, {TOL_LSE:g} x max|plain| + {TOL_LSE:g} for lse (f32 "
        "on both sides from the same operands, in either dtype), "
        + ", ".join(f"{v:g} ({k})" for k, v in TOL_BWD.items()) + " for dq, dk, dv")
    log(f"{'kernel':>6} {'dtype':>8} {'B':>2} {'T':>5} {'S':>5} {'D':>3} {'err/scale':>10} "
        f"{'ms':>8} {'plain_ms':>9} {'sdpa_ms':>8} {'bound_ms':>9}")
    with f32_precision():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for D in (64, 48):
                for B in (1, TRAIN_BATCH):
                    for T, S in ATTN_SHAPES:
                        def rand(n):
                            return torch.randn(B, HEADS, n, D, device="cuda",
                                               generator=gen).to(dtype)
                        q, k, v, do = rand(T), rand(S), rand(S), rand(T)
                        out, lse = flash_mha_fwd(q, k, v)
                        ref, ref_lse = flash_mha_fwd_plain(q, k, v)
                        grads = flash_mha_bwd(q, k, v, out, lse, do)
                        refs = flash_mha_bwd_plain(q, k, v, out, lse, do)
                        torch.cuda.synchronize()
                        errs = {"out": _err(out, ref), "lse": _err(lse, ref_lse)}
                        errs.update({g: _err(a, b) for g, a, b in zip(("dq", "dk", "dv"),
                                                                      grads, refs)})
                        for what, (err, scale) in errs.items():
                            tol, floor = {"out": (TOL[name], 0.0),
                                          "lse": (TOL_LSE, TOL_LSE)}.get(
                                              what, (TOL_BWD[name], 0.0))
                            if not err <= tol * scale + floor:
                                raise AssertionError(
                                    f"{what} disagrees with plain at {name} B={B} T={T} "
                                    f"S={S} D={D}: {err} > {tol} * {scale} + {floor}")
                        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
                        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
                        timings = {
                            "K2": (lambda: flash_mha_fwd(q, k, v),
                                   lambda: flash_mha_fwd_plain(q, k, v),
                                   lambda: F.scaled_dot_product_attention(q, k, v),
                                   ("out", "lse")),
                            "K3": (lambda: flash_mha_bwd(q, k, v, out, lse, do),
                                   lambda: flash_mha_bwd_plain(q, k, v, out, lse, do),
                                   lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                                               retain_graph=True),
                                   ("dq", "dk", "dv")),
                        }
                        for kern, (fn, plain, lib, names) in timings.items():
                            ms, plain_ms, lib_ms = (time_ms(fn, 10), time_ms(plain, 3),
                                                    time_ms(lib, 10))
                            bound, bound_by = attention_bound_ms(B, T, S, D, dtype, kern)
                            err = max(errs[x][0] for x in names)
                            rel = max(errs[x][0] / errs[x][1] for x in names)
                            rows.append(dict(kernel=kern, dtype=name, B=B, T=T, S=S, D=D,
                                             err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                                             library_ms=lib_ms, bound_ms=bound,
                                             bound_by=bound_by))
                            log(f"{kern:>6} {name:>8} {B:>2} {T:>5} {S:>5} {D:>3} "
                                f"{rel:>10.2e} {ms:>8.3f} {plain_ms:>9.3f} {lib_ms:>8.3f} "
                                f"{bound:>9.4f}")
                        del sdpa_out, qg, kg, vg
    return rows


def phase_main_path(card: str):
    """Inference: htdemucs-4s through the port's CLI on the GPU; returns
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
        profile = profile_device(lambda: sep(track), "one warm separation")
    expected = cfg.t_layers * 2 * n_batches
    want = {"flash_mha": expected, "flash_mha_fwd": 0, "flash_mha_bwd": 0}
    if launches != want:
        raise AssertionError(f"inference launches {launches}, want {want} (K1 10 per "
                             f"segment batch x {n_batches}, K2 and K3 never)")
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
    ("attention fwd (K2)", ("mha_fwd_lse_kernel",)),
    ("attention bwd (K3)", ("mha_bwd_kernel",)),
    # cuDNN's implicit-GEMM convolutions are named fprop/dgrad/wgrad,
    # cuBLAS's products gemm; both are "xmma" kernels
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn")),
    ("fft", ("fft",)),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("reduction", ("reduce", "norm")),
    ("copy", ("copy", "memcpy", "memset", "cat", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_device(fn, what: str) -> dict:
    """One more warm call of `fn` under torch.profiler: device time by
    layer, the largest kernels, and the device's busy share of the wall
    time (the profiler's own overhead is in that wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    # device-side events only: a host op's self device time is that of
    # the kernels it launched, which are listed themselves; a user
    # annotation's device span (Optimizer.step) covers kernels listed too
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(ms for _, ms, _ in kernels)
    if not device_ms:
        log(f"profile of {what}: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    by_class: dict[str, float] = {}
    for key, ms, _ in kernels:
        name = key.lower()
        cls = next((c for c, frags in KERNEL_CLASSES if any(f in name for f in frags)),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    n_kernels = sum(count for _, _, count in kernels)
    log(f"profile of {what}: {n_kernels} device kernels and copies, "
        f"device {device_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"({device_ms / wall_ms:.1%} busy)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {cls:>18} {ms:9.2f} ms  {ms / device_ms:6.1%}")
    for key, ms, count in top:
        log(f"  {ms:9.2f} ms  x{count:<5} {key[:100]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_kernels=n_kernels,
                busy_share=device_ms / wall_ms, by_class_ms=by_class,
                top_kernels=[dict(name=k[:100], ms=ms, count=c) for k, ms, c in top])


def _train_cli(argv: list[str]) -> str:
    """demucs_tpu_torch.tools.train_cli.main in this process; returns its
    log (stderr), which is echoed."""
    from demucs_tpu_torch.tools import train_cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = train_cli.main(argv)
    text = err.getvalue()
    for line in text.splitlines():
        log(f"  train_cli: {line}")
    if rc != 0:
        raise RuntimeError(f"train_cli.main exited {rc}")
    return text


_STEP_LINE = re.compile(r"step (\d+)/\d+\s+loss (\S+)\s+step_s (\S+)")


def phase_training(card: str):
    """Training: full-width htdemucs-4s through the port's training CLI
    on the GPU, then resumed; returns (launch counts, steps, summary)."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import HTDEMUCS_4S, SAMPLE_RATE, SEGMENT_SAMPLES
    from demucs_tpu_torch.data import augmented_step, draw_augmentation
    from demucs_tpu_torch.models import build_htdemucs
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import from_state_dict, htdemucs_schema, init_flat
    from demucs_tpu_torch.train import TrainStep

    cfg = HTDEMUCS_4S
    per_step = cfg.t_layers * 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = ["--synthetic", "--family", "htdemucs_4s", "--device", "cuda",
                  "--batch", str(TRAIN_BATCH), "--ema", "0.999", "--ckpt", str(tmp / "ckpt"),
                  "--save-every", "2", "--log-every", "1", "--seed", "0"]
        for kernel in KERNELS:
            kernel.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log1 = _train_cli(common + ["--steps", str(TRAIN_STEPS),
                                    "--export-ggml", str(tmp / "trained.bin")])
        torch.cuda.synchronize()
        first = {kernel.__name__: kernel.launches for kernel in KERNELS}
        peak_mem = torch.cuda.max_memory_allocated()
        log2 = _train_cli(common + ["--steps", str(RESUME_STEPS), "--resume"])
        torch.cuda.synchronize()
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}

        for n_steps, counts in ((TRAIN_STEPS, first), (RESUME_STEPS, launches)):
            want = {"flash_mha": 0, "flash_mha_fwd": per_step * n_steps,
                    "flash_mha_bwd": per_step * n_steps}
            if counts != want:
                raise AssertionError(f"training launches {counts} after {n_steps} steps, "
                                     f"want {want} (K2, K3 10 per step, K1 never)")
        if f"resumed at step {TRAIN_STEPS}" not in log2:
            raise AssertionError(f"the resumed run did not start at step {TRAIN_STEPS}")
        steps = [[(int(m[1]), float(m[2]), float(m[3])) for m in _STEP_LINE.finditer(text)]
                 for text in (log1, log2)]
        got = [s for s, _, _ in steps[0] + steps[1]]
        if got != list(range(1, RESUME_STEPS + 1)):
            raise AssertionError(f"logged steps {got}")
        losses = [loss for run in steps for _, loss, _ in run]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        warm = [step_s for run in steps for _, _, step_s in run[1:]]  # first step of each run out
        step_s = statistics.median(warm)
        audio_s = TRAIN_BATCH * SEGMENT_SAMPLES / SAMPLE_RATE / step_s

        # the exported weights separate a short track through the inference CLI
        n = 3 * SAMPLE_RATE
        wav = (0.1 * np.random.default_rng(3).standard_normal((2, n))).astype(np.float32)
        audio.write_wav(tmp / "short.wav", wav)
        if cli.main([str(tmp / "trained.bin"), str(tmp / "short.wav"), str(tmp / "stems"),
                     "--device", "cuda", "--batch", "1"]) != 0:
            raise RuntimeError("inference CLI on the exported ggml failed")
        for i, name in enumerate(cfg.sources):
            stem, _ = audio.read_wav(tmp / "stems" / f"target_{i}_{name}.wav")
            if stem.shape != (2, n) or not np.isfinite(stem).all():
                raise AssertionError(f"exported model's stem {name}: {stem.shape}")

    # one more step, warm, under the profiler
    schema = htdemucs_schema(cfg)
    model = build_htdemucs(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda",
                           train=True)
    step = TrainStep(model, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stems = 0.05 * torch.randn(TRAIN_BATCH, cfg.num_sources, 2, SEGMENT_SAMPLES,
                               device="cuda", generator=gen)

    def one_step():
        augmented_step(step, stems, draw_augmentation(stems.shape, gen))

    one_step()
    torch.cuda.synchronize()
    profile = profile_device(one_step, f"one warm training step (batch {TRAIN_BATCH})")
    del step, model, stems
    torch.cuda.empty_cache()

    summary = dict(batch=TRAIN_BATCH, segment_samples=SEGMENT_SAMPLES,
                   steps=RESUME_STEPS, losses=losses, median_warm_step_s=step_s,
                   audio_s_trained_per_s=audio_s, max_memory_allocated=peak_mem,
                   launches=launches, profile=profile, card=card)
    log(f"training: htdemucs-4s, batch {TRAIN_BATCH} x {SEGMENT_SAMPLES} samples, "
        f"{TRAIN_STEPS} steps then resumed to {RESUME_STEPS}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; median warm step {step_s:.4f} s, "
        f"{audio_s:.3f} audio-s trained/s, max_memory_allocated {peak_mem} B, "
        f"launches {launches} [{card}]")
    return launches, RESUME_STEPS, summary


def phase_reference():
    """The same htdemucs-4s on the GPU (CUDA kernel) and the CPU (plain
    attention) must agree on a short segment; returns the mix and the
    CPU's estimate."""
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
    return mix, outs["cpu"]


def phase_reference_training(mix, est):
    """One training step of the full-width htdemucs-4s on a short segment
    on the GPU (K2, K3) and on the CPU (plain twins), from the same
    weights and data: the losses and every parameter's gradient agree.

    The L1 loss's gradient is sign(est - refs). Where the two devices'
    estimates (which differ by ~5e-5 of scale) straddle a reference
    sample, the sign flips, and with references drawn near the estimates
    the gradients of whole layers moved by percents (measured on the
    card: 4.5e-2 of a norm). A constant sign instead makes some gradients
    sums that cancel. So the references are the CPU's estimate on this
    mix (phase_reference, same weights) plus a random sign times a gap
    of 0.1 to 0.5: the sign pattern is random and the same on both
    devices, and what is compared is the backward itself."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import HTDEMUCS_4S
    from demucs_tpu_torch.models import build_htdemucs, feeds_group_norm
    from demucs_tpu_torch.params import from_state_dict, htdemucs_schema, init_flat
    from demucs_tpu_torch.train import TrainStep

    cfg = HTDEMUCS_4S
    schema = htdemucs_schema(cfg)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    rng = np.random.default_rng(7)
    sign = np.sign(rng.standard_normal(est.shape))
    refs = (est + sign * (0.1 + 0.4 * rng.random(est.shape))).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        step = TrainStep(build_htdemucs(cfg, sd, device, train=True))
        loss = step(torch.from_numpy(mix).to(device), torch.from_numpy(refs).to(device))
        out[device] = (loss.item(), {n: p.grad.detach().cpu().double()
                                     for n, p in step.model.named_parameters()})
    (loss_g, grads_g), (loss_c, grads_c) = out["cuda"], out["cpu"]
    if not abs(loss_g - loss_c) <= TRAIN_REF_LOSS_TOL * abs(loss_c):
        raise AssertionError(f"training loss GPU {loss_g} vs CPU {loss_c}")
    top = max(g.abs().max().item() for g in grads_c.values())
    rels, residue = [], 0.0
    for name, gc in grads_c.items():
        gg = grads_g[name]
        if not torch.isfinite(gg).all():
            raise AssertionError(f"non-finite GPU gradient {name}")
        if feeds_group_norm(name):
            residue = max(residue, abs(gg.mean().item() - gc.mean().item()))
            gg, gc = gg - gg.mean(), gc - gc.mean()
        norm = gc.norm().item()
        rels.append(((gg - gc).norm().item() / norm if norm > 0 else (gg - gc).norm().item(),
                     name))
    rels.sort(reverse=True)
    log("  the 5 largest |diff|/|cpu|: " + ", ".join(f"{n} {r:.2e}" for r, n in rels[:5]))
    worst, worst_name = rels[0]
    if not worst <= TRAIN_REF_GRAD_TOL:
        raise AssertionError(f"GPU vs CPU gradient of {worst_name}: |diff|/|cpu| {worst}")
    if not residue <= TRAIN_REF_GRAD_TOL * top:
        raise AssertionError(f"GroupNorm-removed bias gradient means differ by {residue}, "
                             f"largest gradient entry {top}")
    log(f"reference: one training step of htdemucs-4s (1, 2, 32768), GPU (K2, K3) vs CPU "
        f"(plain twins): loss {loss_g:.8f} vs {loss_c:.8f} (rel {abs(loss_g - loss_c) / loss_c:.2e}, "
        f"tolerance {TRAIN_REF_LOSS_TOL:g}); worst gradient |diff|/|cpu| {worst:.2e} "
        f"({worst_name}; tolerance {TRAIN_REF_GRAD_TOL:g}, {len(grads_c)} tensors; "
        f"the GroupNorm-removed means of the DConv bias gradients, zero up to rounding, "
        f"differ by at most {residue:.2e}, {residue / top:.1e} of the largest entry)")
    return dict(loss_rel_err=abs(loss_g - loss_c) / loss_c, worst_grad_rel_err=worst,
                worst_grad=worst_name)


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

    secs = build.build(flash_attention.SOURCES, force=True)
    log(f"built kernels {', '.join(flash_attention.SOURCES)} from csrc/ in {secs:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    rows = phase_attention()
    train_rows = phase_training_kernels()
    launches, n_batches, summary = phase_main_path(card)
    train_launches, n_steps, train_summary = phase_training(card)
    mix, est = phase_reference()
    train_summary["reference"] = phase_reference_training(mix, est)

    # the kernels line: each kernel at its path's largest call (freq
    # self-attention, f32, D=64, at the path's batch), with the error over
    # all its shapes on that path
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
    for kern, name, source, line in (
            ("K2", "flash_mha_fwd", "flash_mha.cu", 183),
            ("K3", "flash_mha_bwd", "flash_mha_bwd.cu", 263)):
        path_rows = [r for r in train_rows if r["kernel"] == kern and r["dtype"] == "float32"
                     and r["D"] == 64 and r["B"] == TRAIN_BATCH]
        head = next(r for r in path_rows if r["T"] == r["S"] == 2688)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"demucs_tpu_torch/csrc/{source}",
            "replaces": f"demucs_tpu/ops/pallas/attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": max(r["err"] for r in path_rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"q,k,v ({TRAIN_BATCH},{HEADS},2688,64) float32",
            "launches_per_step": train_launches[name] / n_steps,
        })
    log(json.dumps({"main_path": summary}))
    log(json.dumps({"training": train_summary}))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

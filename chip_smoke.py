#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (demucs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --pair DIR   # before/after: DIR holds another checkout

Phases (any failure ends the run with a non-zero exit):
  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the package from csrc/ with nvcc (sm_90a),
     one nvcc per source, all at once, and read the SASS of the attention
     kernels (K1, K2, K3) and of K7's wgmma form: every instantiation must
     issue warpgroup MMAs (HGMMA) on the tensor cores; log registers and
     spills (ptxas) of K3, K5, K4 and K7;
  3. hold each kernel against its plain PyTorch version at every shape
     its path gives it, and time kernel, plain version and the PyTorch
     library call with CUDA events: K1 (inference forward) at the
     inference shapes, K2 (training forward with lse) and K3 (fused
     backward) at the training shapes, K6 (BiLSTM recurrence) at the v3
     shapes and batches 1, 2, 8, timed in turns with cuDNN's bidirectional
     LSTM layer, the port's layer (projection, K6, flips) and the
     projection alone (medians of 10 readings), beside K6's sequential
     floor (its clusters' DSMEM exchange and barrier alone) and the first
     form's (one block's __syncthreads), K5 (the
     fused DConv sub-block) at every DConv shape of both families' paths,
     with the form, cluster size, threads and shared bytes that
     ops/cuda/dconv.py:dconv_plan chose for each,
     K4 (the DConv tail) at v3's encoder-4/5 shapes (CUDA events and
     torch.profiler's device time),
     and K7 (the int8-dequant matmul) at every linear shape of both
     families' --int8 paths and one ragged M in every form (wgmma with 128
     and 64 rows per block, simt), with the faster of the plain twin's
     cuBLAS product and F.linear of the widened weight as its library
     time;
  4. inference: htdemucs-4s and hdemucs_mmi (v3) at full width (random
     weights from seed 0, written as ggml files) each separate a ~20 s
     synthetic stereo WAV through the port's CLI on the GPU; the stems
     must be finite, of the track's length; per segment batch K1 must
     launch 10 times and K5 32 times for htdemucs-4s, K6 8 times, K5 16
     times and K4 4 times for hdemucs_mmi, and no other kernel; each
     separation again in-process, timed warm, and once more under
     torch.profiler (device time by layer, busy share);
  4b. int8 inference: both families again through the CLI with --int8
     (K7 60 times per segment batch beside 10 K1 and 32 K5 for
     htdemucs-4s; 4 K7 beside 8 K6, 16 K5 and 4 K4 for hdemucs_mmi),
     timed warm and profiled, with the weights' bytes on the device; every
     K7 call in the wgmma form; one
     htdemucs-4s separation with --fp8 (no K7: fp8 weights are widened);
     then htdemucs-4s's warm separation with dense and with int8 weights
     in turns, in one process;
  4c. the host side of the track path: htdemucs-4s on a 45 s track and
     on the 20 s track, hdemucs_mmi on the 20 s track, each in six modes
     (pipeline depth 1 and 2, the fused pass with exact and geo buckets,
     depth 2 and fused with int16 transfers): launch counts per segment
     batch (or group of the fused pass) asserted, each mode held against
     depth 1 (depth 2 bit for bit, fused to 1e-5 of scale, int16 within
     its budget), warm calls timed in turns (median and spread), busy
     share, peak memory, and the host split of one warm call at depth 1
     and 2 (prepare, upload, model launch, download, wait, finish: host
     clock and CUDA events); StageTimer's device ms per stage with
     fine_progress for both families; the CLI with --fused
     --transfer-int16 and on a directory of three WAVs;
  4d. bf16 inference: the bf16 forms of K5 (every DConv shape of both
     families), K4 (v3's tails), K6 (v3's recurrences, beside cuDNN's
     bf16 LSTM layer) and K7's bf16-rounded-weight mode (every linear
     shape, beside F.linear of the widened weight) against their plain
     twins in bf16, with times, bounds and their f32 forms' times; both
     families through the CLI with --bf16 (10 K1 and 32 K5 per segment
     batch for htdemucs-4s, 8 K6, 16 K5 and 4 K4 for hdemucs_mmi, every
     launch in its bf16 form) and with --bf16 --int8 (an f32 network: the
     f32 forms, K7 in its bf16-weight mode) and --bf16 --fp8, each timed
     warm and profiled; htdemucs-4s on a 45 s track
     with --bf16 on the default path and the fused pass beside the same
     in f32, in turns (launch counts, bf16 within 0.08 of f32, fused
     within 1e-2 of the default path, busy share, peak memory);
  4e. the fine-tuned bag and streaming: four full-width htdemucs-4s files
     (random weights, seeds 0-3, named htdemucs_ft_{stem}.bin) through the
     CLI's --ft-dir on the 20 s track, dense, --int8, --fp8 and --bf16 (per
     segment batch 40 K1 and 128 K5, + 240 K7 with --int8, each in its
     dtype's form), each stem i held against stem i of model i run alone
     (bit for bit expected; with --bf16 under deterministic cuDNN, and
     within 1e-3 of scale under the default flags, whose bf16 convolution
     algorithms change a decoder's bits from run to run: a --bf16 model
     run twice under both, the first module that differs named), timed
     warm and profiled with the weights' bytes on the device; the bag on a 45 s track on the default path
     and the fused pass in turns (launches, the fused pass within 1e-5 of
     scale, busy share, peak memory) and one call of
     SequentialBagSeparator's fused form (bit for bit the bag's fused
     pass); --ft-dir --fused
     --transfer-int16 on a directory of two WAVs; --stream for
     htdemucs-4s, hdemucs_mmi and the bag on the 20 s track in 1 s chunks
     at --batch 2 (launches per device call asserted; in-process against
     the offline path with the same statistics and no shift, 1e-5 of
     scale; the realtime factor and the emitted samples' latency against
     one segment plus one stride); the bag on the GPU against the CPU on
     a one-segment track;
  4f. serving (demucs_tpu_torch/serving.py, service.py, tools/serve.py)
     for htdemucs-4s, hdemucs_mmi and the bag: each session's demix_track
     against a direct Separator (bit for bit) and against a CPU session;
     a server in a thread on port 0 (/health, /separate of the 20 s WAV
     through the fused pass, median latency of 3, /stream of it in 1 s
     chunks), 4 concurrent uploads to a --no-fused server (fewer device
     calls than one at a time, stems within the int16 budget of the
     serial ones, busy share), every request's launches asserted against
     the feeder's device calls; the exported segment programs calling
     the demucs_tpu_torch:: custom ops, run on the card against the live
     session under torch's default TF32 flags (EXPORT_TOL); K4's call
     time through its custom op;
  4g. the native helpers, the measuring tools and INT8_SKIPS: the ggml
     parser and the WAV codec built with g++ on the card's host and used
     with no fallback to numpy (load_ggml of the full-width htdemucs-4s and
     hdemucs_mmi files and read_wav of the 20 s and 45 s tracks, native
     against numpy, bit for bit and timed in turns), and the share of the
     in-process CLI's wall (20 s and 45 s) spent in load_ggml,
     load_model_params and read_wav; memory_report (f32, int8, a training
     step), profile_hlo (v4, --v3 --int8, --train), bench_bag and
     bench_sweep (dense and int8 lines, --family) each once at small
     counts, their JSON checked (positive times and bytes, int8 weights
     under 0.3 of f32's, the kernels' classes in the profiles) and every
     kernel launch they make counted against the calls they make;
     INT8_SKIPS on the 20 s v4 track against the switch off (the same
     launches, the JAX test's gate 0.035 on the relative norm), peak
     memory, warm wall in turns, and memory_report's activations;
  4h. the acceptance gate (tools/sdr_acceptance.py), with no JAX on the
     machine: seeded full-width htdemucs-4s, htdemucs-6s, hdemucs_mmi and
     four bag models saved as .th checkpoints and converted by
     tools/convert_pth_to_ggml (one also with --orbax), each output equal
     to the fp16-rounded weights; then the port's CLI against the torch
     oracle (tools/torch_inference.py, TF32 off) on the 20 s track at the
     default segment for the three families and --ft-dir: every report
     passes, every stem's cross-implementation SDR at least 40 dB (printed
     with the card), the CLI runs' launches asserted;
  5. training: full-width htdemucs-4s and hdemucs_mmi through the port's
     training CLI, in-process (synthetic stems, EMA, checkpoints, ggml
     export), then resumed for 2 more steps; every loss finite; per step
     K2 and K3 10 launches and K5 32 (htdemucs-4s), K6 8, K5 16 and K4 4
     (hdemucs_mmi), and no other kernel; the exported ggml separates a
     short track through the inference CLI; warm step time, audio-s
     trained per s, peak memory, one step under torch.profiler, and for
     hdemucs_mmi the step's time in K6's forward and in the plain twin's
     recomputing backward (CUDA events); then the CLI's modes, a few
     steps each: htdemucs-4s without remat and with --remat none, dots
     and dots_nb (launches per step as each policy recomputes; --remat
     none must lower the peak memory), both families with --bf16-compute
     (every launch in its bf16 form), htdemucs-4s with --remat none and
     --bf16-compute together, hdemucs_mmi with --remat none,
     --steps-per-call 2, and --eval-every 2 with --eval-sdr (finite L1
     and SDRs, the .eval.jsonl record, the .best checkpoint);
  6. reference checks: htdemucs-4s, hdemucs_mmi and htdemucs-6s on the GPU
     and on the CPU (plain twins) agree on a short segment, dense and with
     int8 weights, and with --bf16 (GPU against CPU within the devices'
     f32 difference plus twice the CPU's own bf16 error, and within 0.08
     of the GPU's f32 result) and
     --bf16 --int8 (3e-4, an f32 network); htdemucs-4s, hdemucs_mmi and
     htdemucs-6s also in one training step (loss and every parameter's
     gradient; 6s: K2 and K3 at D=48), and
     in one bf16-compute step (the median gradient difference within
     twice the CPU's own bf16 error); then determinism: K2, K3, K6, K5 (a
     frequency row over a cluster, a time row in tiles), K7 and K4 twice on
     one input agree bit for bit, and one resumed full-width training step
     of each family equals the uninterrupted run's bit for bit (parameters
     and EMA);
  6b. several ranks on one card (`demucs_tpu_torch/parallel/`): 2 ranks
     spawned with torch.multiprocessing share cuda:0 under gloo (a check
     that the distributed path is right, not of how it scales): through
     the CLI's rank body on the 20 s track, htdemucs-4s at dp=2 and at
     tp=2 (K1 on each rank's 4 heads), --int8 at tp=2 (K7 at K = 256) and
     hdemucs_mmi at dp=2, each rank's launches asserted and rank 0's stems
     held against the single-process CLI's (MULTI_TOL of scale); one
     full-width htdemucs-4s training step at tp=2 and at dp=2 (K2, K3, K5)
     against the one-process step (loss, every gathered gradient); a
     1-rank NCCL mesh's ShardedSeparator against Separator, bit for bit;
  7. a `kernels` JSON line (with each kernel's launches per rank in the
     multi-rank runs), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Without a GPU it exits non-zero before printing any result.

With --pair DIR it runs only a before/after comparison: the warm
separation of both families (time, profiled kernel count and busy share),
the warm training step (time, peak memory), and K5, K7 and K4 alone at
their B = 2 path shapes, measured in turns with
the demucs_tpu_torch of DIR, of this checkout, of this checkout again and
of DIR again, each in a process of its own (`--probe ROOT`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import itertools
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
PEAK_TF32_TENSOR = 495e12       # FLOP/s, TF32 tensor cores
PEAK_HBM = 3.35e12              # bytes/s

TRACK_SECS = 20.0
MAIN_BATCH = 2                  # segments per device call on the inference path
# (T, S) of the crosstransformer's 10 calls per segment: freq self, time
# self, freq-to-time cross, time-to-freq cross (5 layers x 2 branches)
ATTN_SHAPES = ((2688, 2688), (1344, 1344), (2688, 1344), (1344, 2688))
HEADS = 8
TP_HEADS = 4                    # a rank's heads at tp=2 (phase_multi_rank)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # max|kernel - plain| / max|plain|
# K2's lse is f32 on both sides, from the same operands, in either dtype
TOL_LSE = 1e-5                  # of max|plain lse|, plus as much absolute
# K3's gradients sum over one more axis than the forward
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_BATCH = 4                 # segments per training step
MULTI_TRAIN_BATCH = 2           # full segments in phase_multi_rank's training step
# (heads, batch) of a K2/K3 call: one card's training step, then a rank's
# at dp=2 (8 heads, half the batch) and at tp=2 (4 heads, the whole batch)
TRAIN_ATTN_CALLS = ((HEADS, 1), (HEADS, TRAIN_BATCH), (TP_HEADS, 1),
                    (TP_HEADS, MULTI_TRAIN_BATCH))
TRAIN_STEPS, RESUME_STEPS = 4, 6
# GPU against CPU, one training step: each parameter's gradient to 1e-3
# of its own norm (the forward alone agrees to ~5e-5 of scale), the loss
# to 1e-5 relative
TRAIN_REF_GRAD_TOL, TRAIN_REF_LOSS_TOL = 1e-3, 1e-5
# (T, H) of the v3 BiLSTM's calls: encoder 4 (336 frames, H=192) and the
# shared encoder 5 (168 frames, H=384), at the full 343980-sample segment
LSTM_SHAPES = ((336, 192), (168, 384))
# segments per call: 1, the main path's 2, and the CLI's default 8
LSTM_BATCHES = (1, MAIN_BATCH, 8)
# K6 against its plain twin: h lies in (-1, 1), so an absolute tolerance
TOL_K6 = 1e-5
# K6, the port's BiLSTM layer and cuDNN's are timed in turns: TURNS
# readings each, every reading the mean of TURN_REPS back-to-back calls
TURNS, TURN_REPS = 10, 5
# the DConv shapes of a full segment: frequency levels 0-3 fold B x {512,
# 128, 32, 8} rows of 336 frames, time levels 0-3 are one row per segment
# of {85995, 21499, 5375, 1344} samples; channels 48 x 2^level, hidden
# C/8 (htdemucs) or C/4 (hdemucs_mmi); dilations 1 and 2
DCONV_FREQ_ROWS = (512, 128, 32, 8)
DCONV_FREQ_T = 336
DCONV_TIME_T = (85995, 21499, 5375, 1344)
DCONV_COMP = {"htdemucs_4s": 8, "hdemucs_mmi": 4}
# segments per call: 1 (a --stream call of one ready segment), the main
# path's and the CLI's default
DCONV_BATCHES = (1, MAIN_BATCH, 8)
# K4 on hdemucs_mmi's encoder-4/5 tails: (C, T) of x (B, 2C, T)
TAIL_SHAPES = ((768, 336), (1536, 168))
# K7's linears: (K, N) of htdemucs-4s's Q, K, V and output projections,
# linear1 and linear2, over M = B x {2688 frequency, 1344 time} tokens;
# (T, K, N) of hdemucs_mmi's BiLSTM output linears (encoder 4: 336 frames,
# 2H = 384 -> H = 192; encoder 5: 168 frames, 768 -> 384), M = B x T
INT8_KN_V4 = ((512, 512), (512, 2048), (2048, 512))
# a rank's (K, N) under --int8 --tp 2: Q, K and V (N = C/2), out_proj
# (K = C/2), linear1 (N = 4C/2), linear2 (K = 4C/2)
INT8_KN_V4_TP2 = ((512, 256), (256, 512), (512, 1024), (1024, 512))
INT8_TOKENS_V4 = (2688, 1344)
INT8_V3 = ((336, 384, 192), (168, 768, 384))
INT8_BATCHES = (MAIN_BATCH, 8)
INT8_RAGGED_M = 1000            # no multiple of K7's 128-row tile
# GPU against CPU, separation of one short segment: the tolerance
# tests/test_model_v4.py and tests/test_model_v3.py allow
SEP_REF_TOL = 3e-4
# the bag's stem i against model i run alone through the same path, of the
# output's scale (the same kernels on the same inputs: bit for bit expected;
# with --bf16 under deterministic_cudnn(), see phase_bf16_repeat)
BAG_ALONE_TOL = 1e-6
# --bf16 under cuDNN's default algorithms, which change a decoder
# convolution's bits from run to run: one model run twice differed by up to
# 4.2e-4 of the output's scale on an H100 (phase_bf16_repeat)
BAG_BF16_DEFAULT_TOL = 1e-3


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


def attention_bound(B, T, S, D, dtype, kind: str = "K1", H: int = HEADS) -> dict:
    """K1: 4 BHTSD flops, q, k, v read and o written once; K2: the same
    plus lse (B, H, T) f32 written; K3: 10 BHTSD flops (five products),
    q, k, v, o, lse, dO read and dq, dk, dv written once. f32 takes the
    lesser of two bounds: f32 FMAs on the CUDA cores, and 3xTF32 on the
    tensor cores (three TF32 products for each f32 one, f32 accuracy);
    bf16 the bf16 tensor cores. -> bound_ms, bound_by, the rate it was
    taken at (bound_rate) and the CUDA-core bound beside it."""
    import torch

    BH, e = B * H, torch.tensor([], dtype=dtype).element_size()
    if kind == "K3":
        flops, nbytes = 10.0 * BH * T * S * D, e * BH * D * (4 * T + 4 * S) + 4.0 * BH * T
    else:
        flops = 4.0 * BH * T * S * D
        nbytes = 2.0 * BH * (T + S) * D * e + (4.0 * BH * T if kind == "K2" else 0.0)
    ms, by = bound_ms(flops, nbytes, dtype)
    out = dict(bound_ms=ms, bound_by=by, bound_rate="bf16 tensor cores",
               bound_cuda_core_ms=None)
    if dtype == torch.float32:
        t_ops, t_bytes = 3.0 * flops / PEAK_TF32_TENSOR, nbytes / PEAK_HBM
        out.update(bound_rate="f32 CUDA cores", bound_cuda_core_ms=ms)
        if 1e3 * max(t_ops, t_bytes) < ms:
            out.update(bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       bound_rate="3xTF32 tensor cores")
    return out


# the form of K1 and K2 (csrc/flash_mha.cu), for the kernels line
FWD_FORM = ("wgmma on the tensor cores: 3xTF32 (f32), bf16 m64nNk16 (bf16); one producer "
            "warpgroup fills a 2-stage mbarrier ring of K and V^T tiles, two consumer "
            "warpgroups of 64 query rows each")
# the form of K3 (csrc/flash_mha_bwd.cu), for the kernels line
BWD_FORM = ("wgmma on the tensor cores: 3xTF32 (f32), bf16 m64nNk16 with P and dS rounded "
            "(bf16); one block per 64-key tile of one batch*head, one producer warpgroup "
            "writes each 32-row tile of Q and dO natural and transposed into one of 2 slots, "
            "two consumer warpgroups take the tiles in turns (S^T, dP^T, dQ^T m64n32 from "
            "shared memory; dV, dK m64nD with P^T, dS^T from registers), dK and dV in "
            "registers; dQ as per-key-tile partials summed in tile order by a second kernel")
# the forms of K5 (csrc/dconv.cu), for the kernels line
K5_FORM = ("one launch per frequency row ('row': a block of 256 or 512 threads holds the "
           "row; 'cluster': 2-8 blocks split its T, statistics over DSMEM), three over tiles "
           "of a time row ('tiles': per-block partial sums reduced in a fixed order); "
           "register-blocked conv0 and conv1 from shared memory on the CUDA cores, weights "
           "staged whole or in chunks; z's sums from the Gram matrix of w3 at h <= 24")
# the forms of K7 (csrc/quant_matmul.cu), for the kernels line
K7_FORM = ("'wgmma' (K % 16 == 0, x and q 16-byte aligned: every path shape): 2xTF32 on the "
           "tensor cores (x split into hi and lo, int8 exact in TF32); a producer warpgroup "
           "copies raw x and q tiles with cp.async four 32-deep stages ahead into a 6-slot "
           "mbarrier ring and widens q (k permuted) into the B tile; 1 or 2 consumer "
           "warpgroups of 64 rows x 128 columns split x in registers and run wgmma "
           "m64n128k8 with A from registers, each stage in a fresh accumulator added into "
           "an f32 running sum; 'simt' (the rest): a register-blocked SGEMM on the CUDA cores")
# the forms of K4 (csrc/dconv.cu), for the kernels line
K4_FORM = ("two launches: per-chunk partial sums of x through a workspace in device memory, "
           "reduced in a fixed order by every block of the apply launch (x read twice)")
_ATTN_KERNEL = re.compile(
    r"(mha_fwd_kernel|mha_fwd_lse_kernel|mha_bwd_kernel)I(f|13__nv_bfloat16)Li(\d+)E")


def _attn_name(mangled: str) -> str | None:
    """"mha_fwd_kernel<f32,64>" for an attention kernel's mangled name."""
    m = _ATTN_KERNEL.search(mangled)
    return m and f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'},{m.group(3)}>"


_QUANT_KERNEL = re.compile(r"(int8_matmul_(?:wgmma|simt)_kernel)IL[ib](\d+)ELb(\d)E")


def _quant_name(mangled: str) -> str | None:
    """"int8_matmul_wgmma_kernel<2,bf16w>" for a kernel of
    csrc/quant_matmul.cu: its consumers (or vec) and its weight mode
    (scaled: the scale after the sum; bf16w: the bf16-rounded weight)."""
    m = _QUANT_KERNEL.search(mangled)
    return m and f"{m.group(1)}<{m.group(2)},{'bf16w' if m.group(3) == '1' else 'scaled'}>"


def sass_hgmma(source: str, short=None) -> dict[str, int]:
    """Warpgroup MMA instructions (HGMMA) in each kernel of the built
    library of csrc/<source>.cu that `short` names (the attention kernels
    by default): {"mha_fwd_kernel<f32,64>": n, ...}."""
    from demucs_tpu_torch.ops.cuda import build

    counts = {}
    for kernel, n in build.sass_counts(source, "HGMMA").items():
        name = (short or _attn_name)(kernel)
        if name:
            counts[name] = n
    return counts


_DCONV_KERNEL = re.compile(
    r"(dconv_row_kernel|dconv_tile_[a-z0-9]+_kernel|gn_glu_[a-z]+_kernel)I(f|13__nv_bfloat16)E")


def _dconv_name(mangled: str) -> str | None:
    """"dconv_row_kernel<bf16>" for a kernel of csrc/dconv.cu's mangled name."""
    m = _DCONV_KERNEL.search(mangled)
    return m and f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"


def ptxas_resources(source: str, short=_attn_name) -> dict[str, dict]:
    """Registers and spilled bytes of each kernel of csrc/<source>.cu that
    `short` names (the attention kernels by default), from the ptxas
    report (-Xptxas -v) of this process's build."""
    from demucs_tpu_torch.ops.cuda import build

    out, name = {}, None
    for line in build.build_logs.get(source, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = short(m.group(1))
            if name:
                out[name] = {}
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return out


def phase_attention():
    """Hold flash_mha against flash_mha_plain at every main-path shape:
    8 heads a call on one card, 4 a rank at tp=2 (phase_multi_rank)."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.ops.cuda import flash_mha, flash_mha_plain
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    log("flash_mha vs flash_mha_plain, tolerance max|kernel - plain| <= "
        + ", ".join(f"{v:g} ({k})" for k, v in TOL.items()) + " x max|plain|")
    log("bound_ms: f32 at the 3xTF32 tensor-core rate, bf16 at the bf16 one; "
        "cc_bound: f32 FMAs on the CUDA cores")
    log(f"{'dtype':>8} {'B':>2} {'H':>2} {'T':>5} {'S':>5} {'D':>3} {'err/scale':>10} "
        f"{'ms':>8} {'plain_ms':>9} {'sdpa_ms':>8} {'bound_ms':>9} {'cc_bound':>9}")
    with torch.inference_mode(), f32_precision():
        for dtype, D, H, B in itertools.product((torch.float32, torch.bfloat16), (64, 48),
                                                (HEADS, TP_HEADS), (1, 2)):
            for T, S in ATTN_SHAPES:
                def rand(n):
                    return torch.randn(B, H, n, D, device="cuda",
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
                        f"B={B} H={H} T={T} S={S} D={D}: {err} > {TOL[name]} * "
                        f"{scale}")
                ms = time_ms(lambda: flash_mha(q, k, v), 10)
                plain_ms = time_ms(lambda: flash_mha_plain(q, k, v), 5)
                lib_ms = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), 10)
                bound = attention_bound(B, T, S, D, dtype, H=H)
                rows.append(dict(dtype=name, B=B, H=H, T=T, S=S, D=D, err=err,
                                 rel_err=err / scale, ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms, **bound))
                log(f"{name:>8} {B:>2} {H:>2} {T:>5} {S:>5} {D:>3} "
                    f"{err / scale:>10.2e} "
                    f"{ms:>8.3f} {plain_ms:>9.3f} {lib_ms:>8.3f} "
                    f"{bound['bound_ms']:>9.4f} {_ms(bound['bound_cuda_core_ms']):>9}")
    return rows


def _ms(x) -> str:
    return "-" if x is None else f"{x:.4f}"


def _pct(x) -> str:
    return "not measured" if x is None else f"{x:.1%}"


def _err(out, ref) -> tuple[float, float]:
    """(max|out - ref|, max|ref|) in f32."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item(), ref.abs().max().item()


def phase_training_kernels():
    """Hold K2 (flash_mha_fwd: out, lse) and K3 (flash_mha_bwd: dq, dk,
    dv) against their plain twins at every training shape (8 heads a
    call on one card, 4 a rank at tp=2: TRAIN_ATTN_CALLS), and time
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
    log(f"{'kernel':>6} {'dtype':>8} {'B':>2} {'H':>2} {'T':>5} {'S':>5} {'D':>3} "
        f"{'err/scale':>10} {'ms':>8} {'plain_ms':>9} {'sdpa_ms':>8} {'bound_ms':>9} "
        f"{'cc_bound':>9}")
    with f32_precision():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for D, (H, B) in itertools.product((64, 48), TRAIN_ATTN_CALLS):
                for T, S in ATTN_SHAPES:
                    def rand(n):
                        return torch.randn(B, H, n, D, device="cuda",
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
                                f"{what} disagrees with plain at {name} B={B} H={H} "
                                f"T={T} S={S} D={D}: {err} > {tol} * {scale} + {floor}")
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
                        bound = attention_bound(B, T, S, D, dtype, kern, H)
                        err = max(errs[x][0] for x in names)
                        rel = max(errs[x][0] / errs[x][1] for x in names)
                        rows.append(dict(kernel=kern, dtype=name, B=B, H=H, T=T, S=S, D=D,
                                         err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms, **bound))
                        log(f"{kern:>6} {name:>8} {B:>2} {H:>2} {T:>5} {S:>5} {D:>3} "
                            f"{rel:>10.2e} {ms:>8.3f} {plain_ms:>9.3f} {lib_ms:>8.3f} "
                            f"{bound['bound_ms']:>9.4f} "
                            f"{_ms(bound['bound_cuda_core_ms']):>9}")
                    del sdpa_out, qg, kg, vg
    return rows


def lstm_bound_ms(T, B, H) -> tuple[float, str]:
    """K6: 16·T·B·H² f32 flops (both directions' h @ w_hh), xs (T,2,B,4H)
    and w_hh (2,H,4H) read and ys (T,2,B,H) written once."""
    import torch

    return bound_ms(16.0 * T * B * H * H, 4.0 * (T * 2 * B * 4 * H + 2 * H * 4 * H
                                                 + T * 2 * B * H), torch.float32)


def time_turns(fns: dict, rounds: int = TURNS, reps: int = TURN_REPS) -> dict:
    """The functions of `fns` timed in turns with CUDA events, after two
    warm-up calls each: `rounds` readings per function, each the mean of
    `reps` back-to-back calls; {name: (median ms, readings)}."""
    import torch

    for fn in fns.values():
        fn()
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            readings[name].append(start.elapsed_time(end) / reps)
    return {name: (statistics.median(r), r) for name, r in readings.items()}


def phase_lstm():
    """Hold K6 (bilstm_recurrence) against its plain twin at every v3
    shape and batch, and time it against its sequential floors and the
    layers around it: K6, the port's whole layer (the projection GEMM, K6
    and the flips, weights packed once as the model packs them), cuDNN's
    bidirectional LSTM layer (nn.LSTM, one layer, the yardstick) and the
    projection alone, in turns (medians of TURNS readings); the plain
    twin; the floor of this form (K6's clusters running T steps of the
    DSMEM exchange of h and the cluster barrier, nothing else) and of the
    first form (one block, T steps of __syncthreads)."""
    import torch

    from demucs_tpu_torch.ops.cuda import bilstm_recurrence, bilstm_recurrence_plain
    from demucs_tpu_torch.ops.cuda.lstm import launch_block_floor, launch_cluster_floor
    from demucs_tpu_torch.ops.lstm import _bilstm_layer, pack_bilstm_layer
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    log(f"bilstm_recurrence (K6) vs bilstm_recurrence_plain, tolerance max|kernel - plain| "
        f"<= {TOL_K6:g} (absolute: h lies in (-1, 1)); cuDNN = nn.LSTM(H, H, "
        f"bidirectional) one layer, port layer = projection + K6 + flips; K6, layer, cuDNN "
        f"and projection are medians of {TURNS} readings taken in turns")
    log(f"{'T':>4} {'B':>2} {'H':>4} {'max_err':>9} {'ms':>8} {'plain_ms':>9} {'floor_ms':>9} "
        f"{'blk_floor':>9} {'cudnn_ms':>9} {'layer_ms':>9} {'proj_ms':>8} {'bound_ms':>9} "
        f"{'layer_vs_cudnn':>14}")
    with torch.inference_mode(), f32_precision():
        for T, H in LSTM_SHAPES:
            for B in LSTM_BATCHES:
                xs = torch.randn(T, 2, B, 4 * H, device="cuda", generator=gen)
                w_hh = torch.randn(2, H, 4 * H, device="cuda", generator=gen) / H ** 0.5
                ys = bilstm_recurrence(xs, w_hh)
                ref = bilstm_recurrence_plain(xs, w_hh)
                torch.cuda.synchronize()
                err = (ys - ref).abs().max().item()
                if not err <= TOL_K6:
                    raise AssertionError(f"bilstm_recurrence disagrees with plain at T={T} "
                                         f"B={B} H={H}: {err} > {TOL_K6}")
                lstm = torch.nn.LSTM(H, H, 1, bidirectional=True, batch_first=True,
                                     device="cuda")
                with torch.no_grad():
                    for p in lstm.parameters():
                        p.copy_(torch.randn(p.shape, device="cuda", generator=gen) / H ** 0.5)
                packed = pack_bilstm_layer(
                    {d: {name: getattr(lstm, f"{name}_l0{sfx}") for name in
                         ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
                     for d, sfx in (("forward", ""), ("reverse", "_reverse"))})
                w_ih, bias, _ = packed
                x = torch.randn(B, T, H, device="cuda", generator=gen)
                layer_diff = (_bilstm_layer(x, packed) - lstm(x)[0]).abs().max().item()
                turns = time_turns({
                    "k6": lambda: bilstm_recurrence(xs, w_hh),
                    "layer": lambda: _bilstm_layer(x, packed),
                    "cudnn": lambda: lstm(x),
                    "projection": lambda: torch.matmul(x, w_ih.t()) + bias})
                ms, layer_ms, cudnn_ms, proj_ms = (turns[k][0] for k in
                                                   ("k6", "layer", "cudnn", "projection"))
                plain_ms = time_ms(lambda: bilstm_recurrence_plain(xs, w_hh), 2)
                floor_ms = time_ms(lambda: launch_cluster_floor(T, B, H), 10)
                block_floor_ms = time_ms(lambda: launch_block_floor(T, B, H), 10)
                bound, bound_by = lstm_bound_ms(T, B, H)
                rows.append(dict(T=T, B=B, H=H, err=err, ms=ms, plain_ms=plain_ms,
                                 floor_ms=floor_ms, block_floor_ms=block_floor_ms,
                                 library_ms=cudnn_ms, port_layer_ms=layer_ms,
                                 projection_ms=proj_ms, bound_ms=bound, bound_by=bound_by,
                                 layer_vs_cudnn_max_abs=layer_diff,
                                 readings_ms={k: v[1] for k, v in turns.items()}))
                log(f"{T:>4} {B:>2} {H:>4} {err:>9.2e} {ms:>8.4f} {plain_ms:>9.3f} "
                    f"{floor_ms:>9.4f} {block_floor_ms:>9.4f} {cudnn_ms:>9.3f} "
                    f"{layer_ms:>9.3f} {proj_ms:>8.4f} {bound:>9.4f} {layer_diff:>14.2e}")
                log("     readings ms: " + "; ".join(
                    f"{k} " + " ".join(f"{t:.4f}" for t in v[1]) for k, v in turns.items()))
    return rows


def dconv_bound_ms(N, C, h, T) -> tuple[float, str]:
    """K5: the two convolutions' 10·N·T·C·h f32 flops plus about 15 per
    element of y and of out (norms, GELU, GLU); x read and out written
    once, the weights once."""
    import torch

    return bound_ms(N * T * (10.0 * C * h + 15.0 * (h + C)),
                    4.0 * (2 * N * C * T + 5 * C * h + 3 * h + 5 * C), torch.float32)


def tail_bound_ms(R, C, T) -> tuple[float, str]:
    """K4: about 15 f32 operations per output element (statistics, two
    normalisations, sigmoid, scale, residual); x (R, 2C, T) and res read
    and out (R, C, T) written once."""
    import torch

    return bound_ms(15.0 * R * C * T, 4.0 * (4 * R * C * T + 5 * C), torch.float32)


def dconv_shapes(B: int):
    """(level, N, C, T) of every DConv call of a segment batch of B."""
    for lvl, rows in enumerate(DCONV_FREQ_ROWS):
        yield f"freq{lvl}", B * rows, 48 << lvl, DCONV_FREQ_T
    for lvl, T in enumerate(DCONV_TIME_T):
        yield f"time{lvl}", B, 48 << lvl, T


def profiled_ms(fn, reps: int, fragments) -> float | None:
    """Device time per call of `fn` under torch.profiler: the self device
    time of the kernels whose names hold one of `fragments`, over `reps`
    calls after two unprofiled ones; None if the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(f in e.key for f in fragments))
    return us / 1e3 / reps if us else None


def phase_dconv():
    """Hold K5 (dconv_sub_block) against its plain twin at every DConv
    shape of both families (B = 1, a stream call's, 2, the main path's,
    and 8, the CLI's default) and K4 (gn_glu_scale_res) at v3's encoder-4/5 tails, and time
    each with its twin; K5's rows name the plan each shape got (form,
    cluster size, threads, shared bytes). K4's rows give the device time
    per call from torch.profiler beside the CUDA events' time per call of
    the wrapper (`ms`, what the models call), of the custom op called as
    `torch.ops.demucs_tpu_torch.gn_glu_scale_res` (`op_ms`) and of its
    CUDA implementation called without the dispatcher (`impl_ms`).
    No single PyTorch call computes either function, so there is no
    library time."""
    import torch

    from demucs_tpu_torch.ops.cuda import (dconv_sub_block, dconv_sub_block_plain,
                                           gn_glu_scale_res, gn_glu_scale_res_plain)
    from demucs_tpu_torch.ops.cuda.dconv import (_gn_glu_scale_res_cuda, card_capacity,
                                                 dconv_plan)
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + offset

    def check(what, out, ref):
        err, scale = _err(out, ref)
        if not err <= TOL["float32"] * scale:
            raise AssertionError(f"{what} disagrees with plain: {err} > "
                                 f"{TOL['float32']} * {scale}")
        return err, scale

    rows = []
    log(f"dconv_sub_block (K5) and gn_glu_scale_res (K4) vs their plain twins, tolerance "
        f"max|kernel - plain| <= {TOL['float32']:g} x max|plain| (f32)")
    log(f"{'kernel':>6} {'family':>12} {'B':>2} {'level':>6} {'N':>5} {'C':>5} {'h':>3} "
        f"{'T':>6} {'dil':>3} {'err/scale':>10} {'ms':>8} {'plain_ms':>9} {'bound_ms':>9} "
        f"{'form':>7} {'cs':>3} {'thr':>4} {'launch':>6} {'shared_bytes':>20}")
    with torch.inference_mode(), f32_precision():
        for kind, comp in DCONV_COMP.items():
            for B in DCONV_BATCHES:
                for level, N, C, T in dconv_shapes(B):
                    h = C // comp
                    x = rnd(N, C, T, scale=0.5, offset=0.1)
                    ws = [rnd(h, C, 3, scale=0.3), rnd(h, scale=0.2),
                          rnd(h, scale=0.2, offset=1.0), rnd(h, scale=0.2),
                          rnd(2 * C, h, 1, scale=0.3), rnd(2 * C, scale=0.2),
                          rnd(2 * C, scale=0.2, offset=1.0), rnd(2 * C, scale=0.2),
                          rnd(C, scale=0.1)]
                    for dil in (1, 2):
                        plan = dconv_plan(N, C, h, T, dil, capacity=card_capacity)
                        err, scale = check(
                            f"dconv_sub_block at {kind} B={B} {level} dil={dil}",
                            dconv_sub_block(x, *ws, dil), dconv_sub_block_plain(x, *ws, dil))
                        ms = time_ms(lambda: dconv_sub_block(x, *ws, dil), 10)
                        plain_ms = time_ms(lambda: dconv_sub_block_plain(x, *ws, dil), 3)
                        bound, bound_by = dconv_bound_ms(N, C, h, T)
                        rows.append(dict(kernel="K5", family=kind, B=B, level=level, N=N, C=C,
                                         h=h, T=T, dil=dil, err=err, rel_err=err / scale,
                                         shape=f"x ({N},{C},{T}), h={h}, dil={dil} float32",
                                         ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                         bound_by=bound_by, form=plan.form,
                                         cluster=plan.cluster, threads=plan.threads,
                                         launches_per_call=plan.launches,
                                         shared_bytes=list(plan.smem), gram=plan.gram))
                        log(f"{'K5':>6} {kind:>12} {B:>2} {level:>6} {N:>5} {C:>5} {h:>3} "
                            f"{T:>6} {dil:>3} {err / scale:>10.2e} {ms:>8.3f} "
                            f"{plain_ms:>9.3f} {bound:>9.4f} {plan.form:>7} {plan.cluster:>3} "
                            f"{plan.threads:>4} {plan.launches:>6} "
                            f"{'/'.join(map(str, plan.smem)):>20}")
                    del x, ws
        log(f"{'K4':>6} {'family':>12} {'B':>2} {'level':>6} {'C':>5} {'T':>4} "
            f"{'err/scale':>10} {'ms':>8} {'op_ms':>8} {'impl_ms':>8} {'device_ms':>9} "
            f"{'plain_ms':>9} {'bound_ms':>9}")
        for B in DCONV_BATCHES:
            for C, T in TAIL_SHAPES:
                x, res = rnd(B, 2 * C, T, offset=0.3), rnd(B, C, T)
                w, b = rnd(2 * C, scale=0.2, offset=1.0), rnd(2 * C, scale=0.2)
                scale_c = rnd(C, scale=0.1)
                args = (x, w, b, scale_c, res)
                err, scale = check(f"gn_glu_scale_res at B={B} C={C} T={T}",
                                   gn_glu_scale_res(*args), gn_glu_scale_res_plain(*args))
                ms = time_ms(lambda: gn_glu_scale_res(*args), 10)
                op_ms = time_ms(lambda: torch.ops.demucs_tpu_torch.gn_glu_scale_res(*args), 10)
                impl_ms = time_ms(lambda: _gn_glu_scale_res_cuda(*args), 10)
                device_ms = profiled_ms(lambda: gn_glu_scale_res(*args), 10, ("gn_glu_",))
                plain_ms = time_ms(lambda: gn_glu_scale_res_plain(*args), 5)
                bound, bound_by = tail_bound_ms(B, C, T)
                level = "enc4" if T == 336 else "enc5"
                rows.append(dict(kernel="K4", family="hdemucs_mmi", B=B, level=level, err=err,
                                 rel_err=err / scale, ms=ms, op_ms=op_ms, impl_ms=impl_ms,
                                 device_ms=device_ms,
                                 plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                                 shape=f"x ({B},{2 * C},{T}), res ({B},{C},{T}) float32"))
                log(f"{'K4':>6} {'hdemucs_mmi':>12} {B:>2} {level:>6} {C:>5} {T:>4} "
                    f"{err / scale:>10.2e} {ms:>8.4f} {op_ms:>8.4f} {impl_ms:>8.4f} "
                    f"{_ms(device_ms):>9} {plain_ms:>9.3f} {bound:>9.4f}")
    return rows


def int8_bound(M, N, K) -> dict:
    """K7: 2MNK flops; x (f32), q (int8), scale and bias read and y (f32)
    written once. The lesser of two bounds: f32 FMAs on the CUDA cores, and
    2xTF32 on the tensor cores (two TF32 products per f32 one: int8 is
    exact in TF32, only x is split). -> bound_ms, bound_by, the rate it
    was taken at (bound_rate) and the CUDA-core bound beside it."""
    import torch

    flops, nbytes = 2.0 * M * N * K, 4.0 * M * K + N * K + 8.0 * N + 4.0 * M * N
    cc_ms, cc_by = bound_ms(flops, nbytes, torch.float32)
    t_ops, t_bytes = 2.0 * flops / PEAK_TF32_TENSOR, nbytes / PEAK_HBM
    out = dict(bound_ms=cc_ms, bound_by=cc_by, bound_rate="f32 CUDA cores",
               bound_cuda_core_ms=cc_ms)
    if 1e3 * max(t_ops, t_bytes) < cc_ms:
        out.update(bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_rate="2xTF32 tensor cores")
    return out


def int8_shapes():
    """(family, B, M, K, N) of every K7 call on both families' --int8
    paths at B = 2 and 8, and a rank's of htdemucs-4s at --tp 2, then one
    ragged M."""
    for B in INT8_BATCHES:
        for T in INT8_TOKENS_V4:
            for K, N in INT8_KN_V4:
                yield "htdemucs_4s", B, B * T, K, N
            for K, N in INT8_KN_V4_TP2:
                yield "htdemucs_4s tp=2", B, B * T, K, N
        for T, K, N in INT8_V3:
            yield "hdemucs_mmi", B, B * T, K, N
    yield "ragged", 0, INT8_RAGGED_M, 512, 512


def _int8_operands(gen, M, N, K):
    """x at unit scale, a weight at 1/sqrt(K) quantized per output channel
    (scale (N, 1)), a small bias."""
    import torch

    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5
    scale = torch.clamp(w.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return x, q, scale, torch.randn(N, device="cuda", generator=gen) * 0.01


def phase_quant_matmul():
    """Hold K7 (int8_matmul) against its plain twin at every linear shape
    of both families' --int8 paths, in the form and tiles its plan
    (quant_plan) picks and in every other (the wgmma form with 128 and 64
    rows per block, the simt form), and time each; time the plain twin
    (cuBLAS's f32 x @ q.float().T, TF32 off, then scale and bias) and the
    other PyTorch form, F.linear of the weight widened by PyTorch (the
    widening included): the library time is the faster of the two."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.ops.cuda import int8_matmul, int8_matmul_plain
    from demucs_tpu_torch.ops.cuda.quant_matmul import QuantPlan, launch_plan, quant_plan
    from demucs_tpu_torch.utils.device import f32_precision

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    log(f"int8_matmul (K7) vs int8_matmul_plain, tolerance max|kernel - plain| <= "
        f"{TOL['float32']:g} x max|plain| (f32) in every form; plain = (x @ q.float().T) * "
        f"scale + b, linear = F.linear(x, q.float() * scale, b), library = the faster; "
        f"bound: the lesser of 2xTF32 on the tensor cores and f32 on the CUDA cores (cc)")
    log(f"{'family':>16} {'B':>2} {'M':>6} {'K':>5} {'N':>5} {'plan':>9} {'err/scale':>10} "
        f"{'ms':>8} {'device':>8} {'w128_ms':>8} {'w64_ms':>8} {'simt_ms':>8} {'plain_ms':>9} "
        f"{'linear_ms':>9} {'bound_ms':>9} {'cc_bound':>9}")
    with torch.inference_mode(), f32_precision():
        for family, B, M, K, N in int8_shapes():
            x, q, scale, b = _int8_operands(gen, M, N, K)
            s = scale.reshape(-1)
            plan = quant_plan(M, N, K, x.data_ptr(), q.data_ptr())
            forms = {"simt": QuantPlan("simt", 128, 64, K % 4 == 0, M, N)}
            if K % 16 == 0:
                forms.update(wgmma128=QuantPlan("wgmma", 128, 128, False, M, N),
                             wgmma64=QuantPlan("wgmma", 64, 128, False, M, N))
            ref = int8_matmul_plain(x, q, s, b)
            errs = {"plan": _err(int8_matmul(x, q, s, b), ref)}
            errs.update({f: _err(launch_plan(x, q, s, b, fp), ref) for f, fp in forms.items()})
            for f, (err, ref_scale) in errs.items():
                if not err <= TOL["float32"] * ref_scale:
                    raise AssertionError(f"int8_matmul ({f}) disagrees with plain at {family} "
                                         f"M={M} K={K} N={N}: {err} > {TOL['float32']} * "
                                         f"{ref_scale}")
            err, ref_scale = max(errs.values())
            ms = time_ms(lambda: int8_matmul(x, q, s, b), 20)
            device_ms = profiled_ms(lambda: int8_matmul(x, q, s, b), 20, ("int8_matmul_",))
            form_ms = {f: time_ms(lambda: launch_plan(x, q, s, b, fp), 20)
                       for f, fp in forms.items()}
            plain_ms = time_ms(lambda: int8_matmul_plain(x, q, s, b), 20)
            linear_ms = time_ms(lambda: F.linear(x, q.float() * scale, b), 20)
            bound = int8_bound(M, N, K)
            name = f"{plan.form}{plan.rows if plan.form == 'wgmma' else ''}"
            rows.append(dict(family=family, B=B, M=M, K=K, N=N, err=err,
                             rel_err=err / ref_scale, ms=ms, device_ms=device_ms, plan=name,
                             form_ms=form_ms, plain_ms=plain_ms, linear_ms=linear_ms,
                             library_ms=min(plain_ms, linear_ms),
                             library="(x @ q.float().T) * scale + b" if plain_ms <= linear_ms
                             else "F.linear(x, q.float() * scale, b)", **bound))
            log(f"{family:>16} {B:>2} {M:>6} {K:>5} {N:>5} {name:>9} {err / ref_scale:>10.2e} "
                f"{ms:>8.4f} {_ms(device_ms):>8} {_ms(form_ms.get('wgmma128')):>8} "
                f"{_ms(form_ms.get('wgmma64')):>8} "
                f"{form_ms['simt']:>8.4f} {plain_ms:>9.4f} {linear_ms:>9.4f} "
                f"{bound['bound_ms']:>9.4f} {bound['bound_cuda_core_ms']:>9.4f}")
            del x, q, scale, b, ref
    return rows


def phase_bf16_kernels():
    """Hold the bf16 forms against their plain twins (the f32 function on
    the widened inputs, rounded once) on the card, in bf16, at every path
    shape of the --bf16 paths (B = 2, and 1 for a --stream --bf16 call),
    and time each with its twin: K5 at every DConv shape of both families
    (dilations 1 and 2), K4 at v3's tails, K6 at v3's recurrences (B = 1,
    2, 8) beside cuDNN's bf16 LSTM layer; and K7's bf16-rounded-weight
    mode (the --bf16 --int8 path's) at every linear shape of both families
    in the planned form, beside F.linear of the weight widened by PyTorch. Tolerances: 1e-2 of
    max(|plain|, 1) for the bf16 outputs, 1e-5 of max|plain| for K7's f32
    output. K1's bf16 form is timed in phase_attention."""
    import torch
    import torch.nn.functional as F

    from demucs_tpu_torch.ops.cuda import (bilstm_recurrence, bilstm_recurrence_plain,
                                           dconv_sub_block, dconv_sub_block_plain,
                                           gn_glu_scale_res, gn_glu_scale_res_plain,
                                           int8_matmul, int8_matmul_plain)
    from demucs_tpu_torch.ops.cuda.dconv import card_capacity, dconv_plan
    from demucs_tpu_torch.ops.cuda.quant_matmul import quant_plan
    from demucs_tpu_torch.utils.device import f32_precision

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale + offset).to(bf16)

    def check(what, out, ref, tol):
        err, scale = _err(out, ref)
        if not err <= tol * max(scale, 1.0):
            raise AssertionError(f"{what} disagrees with plain: {err} > {tol} * max({scale}, 1)")
        return err, scale

    rows = []
    log(f"bf16 forms vs their plain twins: K5, K4, K6 max|kernel - plain| <= "
        f"{TOL['bfloat16']:g} x max(max|plain|, 1); K7's bf16-weight mode <= "
        f"{TOL['float32']:g} x max|plain| (f32 out); bound: bf16 tensor-core peak or bytes")
    log(f"{'kernel':>6} {'family':>12} {'level':>8} {'shape':>34} {'err':>9} {'ms':>8} "
        f"{'plain_ms':>9} {'lib_ms':>8} {'bound_ms':>9} {'f32_ms':>8}")
    with torch.inference_mode(), f32_precision():
        for B, (kind, comp) in itertools.product((1, MAIN_BATCH), DCONV_COMP.items()):
            for level, N, C, T in dconv_shapes(B):
                h = C // comp
                x = rnd(N, C, T, scale=0.5, offset=0.1)
                ws = [rnd(h, C, 3, scale=0.3), rnd(h, scale=0.2), rnd(h, scale=0.2, offset=1.0),
                      rnd(h, scale=0.2), rnd(2 * C, h, 1, scale=0.3), rnd(2 * C, scale=0.2),
                      rnd(2 * C, scale=0.2, offset=1.0), rnd(2 * C, scale=0.2),
                      rnd(C, scale=0.1)]
                wf = [w.float() for w in ws]
                xf = x.float()
                for dil in (1, 2):
                    plan = dconv_plan(N, C, h, T, dil, capacity=card_capacity)
                    err, _ = check(f"dconv_sub_block bf16 at {kind} B={B} {level} dil={dil}",
                                   dconv_sub_block(x, *ws, dil),
                                   dconv_sub_block_plain(x, *ws, dil), TOL["bfloat16"])
                    ms = time_ms(lambda: dconv_sub_block(x, *ws, dil), 10)
                    f32_ms = time_ms(lambda: dconv_sub_block(xf, *wf, dil), 10)
                    plain_ms = time_ms(lambda: dconv_sub_block_plain(x, *ws, dil), 3)
                    bound, by = bound_ms(N * T * (10.0 * C * h + 15.0 * (h + C)),
                                         2.0 * (2 * N * C * T + 5 * C * h + 3 * h + 5 * C), bf16)
                    shape = f"x ({N},{C},{T}) h={h} dil={dil}"
                    rows.append(dict(kernel="K5", family=kind, B=B, level=level, dil=dil,
                                     shape=shape + " bfloat16", err=err, ms=ms,
                                     plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                                     bound_by=by, f32_ms=f32_ms, form=plan.form))
                    log(f"{'K5':>6} {kind:>12} {level:>8} {shape:>34} {err:>9.2e} {ms:>8.4f} "
                        f"{plain_ms:>9.3f} {'-':>8} {bound:>9.4f} {f32_ms:>8.4f} {plan.form}")
                del x, ws, xf, wf
        for B, (C, T) in itertools.product((1, MAIN_BATCH), TAIL_SHAPES):
            args = [rnd(B, 2 * C, T, offset=0.3), rnd(2 * C, scale=0.2, offset=1.0),
                    rnd(2 * C, scale=0.2), rnd(C, scale=0.1), rnd(B, C, T)]
            argf = [a.float() for a in args]
            err, _ = check(f"gn_glu_scale_res bf16 at B={B} C={C} T={T}",
                           gn_glu_scale_res(*args), gn_glu_scale_res_plain(*args),
                           TOL["bfloat16"])
            ms = time_ms(lambda: gn_glu_scale_res(*args), 20)
            device_ms = profiled_ms(lambda: gn_glu_scale_res(*args), 10, ("gn_glu_",))
            f32_ms = time_ms(lambda: gn_glu_scale_res(*argf), 20)
            plain_ms = time_ms(lambda: gn_glu_scale_res_plain(*args), 5)
            bound, by = bound_ms(15.0 * B * C * T, 2.0 * (4 * B * C * T + 5 * C), bf16)
            level = "enc4" if T == 336 else "enc5"
            shape = f"x ({B},{2 * C},{T}), res ({B},{C},{T})"
            rows.append(dict(kernel="K4", family="hdemucs_mmi", B=B, level=level,
                             shape=shape + " bfloat16", err=err, ms=ms, device_ms=device_ms,
                             plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
                             f32_ms=f32_ms))
            log(f"{'K4':>6} {'hdemucs_mmi':>12} {level:>8} {shape:>34} {err:>9.2e} {ms:>8.4f} "
                f"{plain_ms:>9.3f} {'-':>8} {bound:>9.4f} {f32_ms:>8.4f} (device "
                f"{_ms(device_ms)})")
        for T, H in LSTM_SHAPES:
            for Bl in LSTM_BATCHES:
                xs = rnd(T, 2, Bl, 4 * H)
                w_hh = (torch.randn(2, H, 4 * H, device="cuda", generator=gen)
                        / H ** 0.5).to(bf16)
                ys = bilstm_recurrence(xs, w_hh)
                err = (ys.float() - bilstm_recurrence_plain(xs, w_hh).float()).abs().max().item()
                if not err <= TOL["bfloat16"]:
                    raise AssertionError(f"bilstm_recurrence bf16 disagrees with plain at T={T} "
                                         f"B={Bl} H={H}: {err} > {TOL['bfloat16']}")
                lstm = torch.nn.LSTM(H, H, 1, bidirectional=True, batch_first=True,
                                     device="cuda", dtype=bf16)
                lstm.flatten_parameters()  # cuDNN's weights in one buffer
                x = rnd(Bl, T, H)
                ms = time_ms(lambda: bilstm_recurrence(xs, w_hh), 10)
                xsf, whf = xs.float(), w_hh.float()
                f32_ms = time_ms(lambda: bilstm_recurrence(xsf, whf), 10)
                lib_ms = time_ms(lambda: lstm(x), 10)
                plain_ms = time_ms(lambda: bilstm_recurrence_plain(xs, w_hh), 2)
                bound, by = bound_ms(16.0 * T * Bl * H * H,
                                     2.0 * (T * 2 * Bl * 4 * H + 2 * H * 4 * H + T * 2 * Bl * H),
                                     bf16)
                shape = f"xs ({T},2,{Bl},{4 * H}) H={H}"
                rows.append(dict(kernel="K6", family="hdemucs_mmi", B=Bl, level=f"T={T}",
                                 shape=shape + " bfloat16", err=err, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bound, bound_by=by, f32_ms=f32_ms))
                log(f"{'K6':>6} {'hdemucs_mmi':>12} {f'B={Bl}':>8} {shape:>34} {err:>9.2e} "
                    f"{ms:>8.4f} {plain_ms:>9.3f} {lib_ms:>8.4f} {bound:>9.4f} {f32_ms:>8.4f}")
        for family, Bq, M, K, N in int8_shapes():
            if Bq not in (MAIN_BATCH, 0):
                continue
            x, q, scale, b = _int8_operands(gen, M, N, K)
            s = scale.reshape(-1)
            plan = quant_plan(M, N, K, x.data_ptr(), q.data_ptr())
            ref = int8_matmul_plain(x, q, s, b, bf16)
            err, ref_scale = _err(int8_matmul(x, q, s, b, weight_dtype=bf16), ref)
            if not err <= TOL["float32"] * ref_scale:
                raise AssertionError(f"int8_matmul bf16-weight mode disagrees with plain at "
                                     f"{family} M={M} K={K} N={N}: {err} > {TOL['float32']} * "
                                     f"{ref_scale}")
            ms = time_ms(lambda: int8_matmul(x, q, s, b, weight_dtype=bf16), 20)
            f32_ms = time_ms(lambda: int8_matmul(x, q, s, b), 20)
            plain_ms = time_ms(lambda: int8_matmul_plain(x, q, s, b, bf16), 20)
            lib_ms = time_ms(lambda: F.linear(x, (q.to(bf16) * scale.to(bf16)).float(), b), 20)
            bound = int8_bound(M, N, K)
            shape = f"x ({M},{K}) q ({N},{K})"
            rows.append(dict(kernel="K7", family=family, B=Bq, level=plan.form, M=M, K=K, N=N,
                             shape=shape, err=err, rel_err=err / ref_scale, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, f32_ms=f32_ms, **bound))
            log(f"{'K7bw':>6} {family:>12} {plan.form:>8} {shape:>34} {err / ref_scale:>9.2e} "
                f"{ms:>8.4f} {plain_ms:>9.4f} {lib_ms:>8.4f} {bound['bound_ms']:>9.4f} "
                f"{f32_ms:>8.4f}")
            del x, q, scale, b, ref
    return rows


def _family(kind: str, quant: str | None = None):
    """(config, schema, launches per segment batch) of an inference
    family: htdemucs-4s (and -6s) runs K1 10 times per segment batch (5
    layers x 2 branches) and K5 32 times (2 branches x 4 encoders and 4 decoders x 2
    DConv sub-blocks); hdemucs_mmi runs K6 8 times (encoders 4 and 5 x 2
    DConv sub-blocks x 2 LSTM layers), K5 16 times (encoders 0-3 x 2
    branches x 2 sub-blocks) and K4 4 times (the tails of encoders 4 and
    5 x 2 sub-blocks); no other kernel launches. With int8 weights
    (`quant="int8"`) K7 also runs on every nn.Linear-layout product:
    htdemucs-4s 60 times (Q, K, V, output projection, linear1 and linear2
    of 5 layers x 2 branches), hdemucs_mmi 4 times (the BiLSTM output
    linear of encoders 4 and 5 x 2 sub-blocks); fp8 weights are widened
    and launch no K7."""
    from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S, HTDEMUCS_6S
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import hdemucs_v3_schema, htdemucs_schema

    if kind in ("htdemucs_4s", "htdemucs_6s"):
        cfg = HTDEMUCS_4S if kind == "htdemucs_4s" else HTDEMUCS_6S
        schema = htdemucs_schema(cfg)
        per_batch = {"flash_mha": cfg.t_layers * 2,
                     "dconv_sub_block": 2 * 2 * cfg.depth * cfg.dconv_depth,
                     "int8_matmul": 6 * cfg.t_layers * 2 if quant == "int8" else 0}
    else:
        cfg, schema = HDEMUCS_V3, hdemucs_v3_schema(HDEMUCS_V3)
        per_batch = {"bilstm_recurrence": cfg.dconv_depth * 2 * 2,
                     "dconv_sub_block": 2 * 4 * cfg.dconv_depth,
                     "gn_glu_scale_res": 2 * cfg.dconv_depth,
                     "int8_matmul": 2 * cfg.dconv_depth if quant == "int8" else 0}
    per_batch = {k.__name__: per_batch.get(k.__name__, 0) for k in KERNELS}
    return cfg, schema, per_batch


def synthetic_track(n: int):
    """A stereo (2, n) f32 track: two tones and noise, from seed 0."""
    import numpy as np

    from demucs_tpu_torch.config import SAMPLE_RATE

    t = np.arange(n) / SAMPLE_RATE
    tones = np.stack([np.sin(2 * np.pi * 220.0 * t), np.sin(2 * np.pi * 331.0 * t)])
    noise = np.random.default_rng(0).standard_normal((2, n))
    return (0.3 * tones + 0.05 * noise).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bag_dir() -> Path:
    """A directory holding the fine-tuned bag's four files as the reference
    names them, htdemucs_ft_{drums,bass,other,vocals}.bin: full-width
    htdemucs-4s with random weights from seeds 0-3. Written once per run,
    removed at exit."""
    import atexit
    import shutil

    from demucs_tpu_torch.params import init_flat, write_ggml

    path = Path(tempfile.mkdtemp(prefix="htdemucs_ft_"))
    atexit.register(shutil.rmtree, path, True)
    cfg, schema, _ = _family("htdemucs_4s")
    for i, stem in enumerate(cfg.sources):
        write_ggml(path / f"htdemucs_ft_{stem}.bin", "htdemucs_4s", init_flat(schema, seed=i))
    return path


def _bag_against_alone(bag, est, track, opts) -> dict:
    """Stem i of the bag's result `est` against stem i of model i run alone
    through a Separator with the same options, and model i alone twice
    (the path's own run-to-run difference), as largest differences."""
    import numpy as np

    from demucs_tpu_torch.pipeline import Separator

    diffs, reruns = [], []
    for i, member in enumerate(bag.models):
        solo = Separator(member, len(bag.models), opts, "cuda")
        first = solo(track)[i]
        diffs.append(float(np.abs(est[i] - first).max()))
        reruns.append(float(np.abs(solo(track)[i] - first).max()))
    return dict(max_abs_diff=max(diffs), per_stem=diffs, scale=float(np.abs(est).max()),
                bit_identical=max(diffs) == 0.0, alone_run_to_run=max(reruns))


def phase_main_path(card: str, kind: str, quant: str | None = None, bf16: bool = False,
                    bag: bool = False):
    """Inference: `kind` (htdemucs_4s or hdemucs_mmi) through the port's
    CLI on the GPU, with `quant` ("int8", "fp8") weights if given and
    with --bf16 if `bf16`; with `bag`, the fine-tuned bag of four
    htdemucs-4s models (`--ft-dir bag_dir()`), each stem i of which is
    then held against stem i of model i run alone through the same
    Separator (with --bf16 under deterministic_cudnn(), and under the
    default flags at BAG_BF16_DEFAULT_TOL). Returns (launch counts, number of segment batches,
    summary). Every kernel launch of the path must be in the dtype the
    path gives it: bf16 on --bf16 alone; f32 with --int8 / --fp8, whose
    network stays f32, K7 then in its bf16-rounded-weight mode with
    --bf16."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_bag, build_model
    from demucs_tpu_torch.ops.cuda import KERNELS, int8_matmul
    from demucs_tpu_torch.params import (cast_state_dict, init_flat, load_model_params,
                                         quantize_fp8, quantize_int8, write_ggml)
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.utils.device import deterministic_cudnn

    cfg, schema, per_batch = _family(kind, quant)
    if bag:
        # four models a call, each with its path's launches
        per_batch = {name: 4 * count for name, count in per_batch.items()}
    # every K7 call of the path in the wgmma form
    fast_form = {int8_matmul: "wgmma"}
    by_dtype = [k for k in KERNELS if hasattr(k, "launches_by_dtype")]
    label = (("htdemucs_ft bag" if bag else kind) + (" --bf16" if bf16 else "")
             + (f" --{quant}" if quant else ""))
    n = int(TRACK_SECS * SAMPLE_RATE)
    offset = 1337
    opts = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=offset)
    shifted = n + int(opts.max_shift_secs * SAMPLE_RATE) - offset
    n_segments = math.ceil(shifted / int((1 - opts.overlap) * opts.segment_samples))
    n_batches = math.ceil(n_segments / MAIN_BATCH)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if bag:
            model_args = ["--ft-dir", str(bag_dir())]
            model_paths = [bag_dir() / f"htdemucs_ft_{stem}.bin" for stem in cfg.sources]
        else:
            model_path = tmp / f"{kind}.bin"
            write_ggml(model_path, kind, init_flat(schema, seed=0))
            model_args, model_paths = [str(model_path)], [model_path]
        wav_path = tmp / "mix.wav"
        audio.write_wav(wav_path, synthetic_track(n))
        outdir = tmp / "stems"

        for kernel in KERNELS:
            kernel.launches = 0
        for kernel in fast_form:
            kernel.form_launches = dict.fromkeys(kernel.form_launches, 0)
        for kernel in by_dtype:
            kernel.launches_by_dtype = dict.fromkeys(kernel.launches_by_dtype, 0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(model_args + [str(wav_path), str(outdir),
                       "--device", "cuda", "--batch", str(MAIN_BATCH),
                       "--offset", str(offset)] + ([f"--{quant}"] if quant else [])
                      + (["--bf16"] if bf16 else []))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        forms = {kernel.__name__: dict(kernel.form_launches) for kernel in fast_form}
        dtypes = {kernel.__name__: dict(kernel.launches_by_dtype) for kernel in by_dtype}
        peak_mem = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"cli.main exited {rc}")

        for i, name in enumerate(cfg.sources):
            stem, rate = audio.read_wav(outdir / f"target_{i}_{name}.wav")
            if rate != SAMPLE_RATE or stem.shape != (2, n) or not np.isfinite(stem).all():
                raise AssertionError(f"stem {name}: rate {rate}, shape {stem.shape}, "
                                     f"finite {np.isfinite(stem).all()}")

        # the same work again in this process, timed by part: the CLI run
        # above also pays the process's one-time set-up costs; the model's
        # weights on the device, as allocated and as the state dict counts
        t0 = time.monotonic()
        state_dicts = [load_model_params(p)[1] for p in model_paths]
        if quant:
            state_dicts = [{"int8": quantize_int8, "fp8": quantize_fp8}[quant](sd)
                           for sd in state_dicts]
        elif bf16:
            state_dicts = [cast_state_dict(sd, torch.bfloat16) for sd in state_dicts]
        mem0 = torch.cuda.memory_allocated()
        quant_dtype = torch.bfloat16 if bf16 else torch.float32
        model = (build_bag(cfg, state_dicts, "cuda", quant_dtype) if bag
                 else build_model(cfg, state_dicts[0], "cuda", quant_dtype=quant_dtype))
        del state_dicts
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        weights_allocated = torch.cuda.memory_allocated() - mem0
        weight_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        sep = Separator(model, cfg.num_sources, opts, "cuda")
        track = audio.load_track(wav_path)
        t0 = time.monotonic()
        est = sep(track)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        profile = profile_device(lambda: sep(track), f"one warm {label} separation")
        alone = splits = None
        if bag:
            # stem i of the bag against stem i of model i alone, through the
            # same Separator path: the same kernels on the same inputs. A bf16
            # network's bits change run to run under cuDNN's default
            # algorithms (phase_bf16_repeat), so there the bit-for-bit
            # comparison runs under deterministic_cudnn() and the default
            # flags' difference is held at BAG_BF16_DEFAULT_TOL
            alone = _bag_against_alone(model, est, track, opts)
            strict = alone
            if bf16 and not quant:
                with deterministic_cudnn():
                    strict = _bag_against_alone(model, sep(track), track, opts)
                if not alone["max_abs_diff"] <= BAG_BF16_DEFAULT_TOL * alone["scale"]:
                    raise AssertionError(f"{label}: stem i against model i alone under the "
                                         f"default cuDNN flags {alone}")
                alone = dict(strict, flags="deterministic_cudnn",
                             default_flags=dict(alone, tolerance=BAG_BF16_DEFAULT_TOL))
            alone["tolerance"] = BAG_ALONE_TOL
            if not strict["max_abs_diff"] <= BAG_ALONE_TOL * max(strict["scale"], 1e-30):
                raise AssertionError(f"{label}: stem i against model i alone {strict}")
            if not (quant or bf16):
                # where a warm call of the bag's batched path goes, at depth 1
                # and 2 (its result bit for bit the call's)
                splits = {}
                for depth in (1, 2):
                    split = host_split(Separator(model, cfg.num_sources, dataclasses.replace(
                        opts, pipeline_depth=depth), "cuda"), track)
                    if not np.array_equal(split.pop("result"), est):
                        raise AssertionError(f"{label} host split at depth {depth}: differs "
                                             f"from the call")
                    splits[depth] = split
                    log(f"host split {label} 20 s, depth {depth}: wall "
                        f"{split['wall_ms']:.1f} ms; host ms " + ", ".join(
                            f"{k} {v:.1f}" for k, v in split["host_ms"].items())
                        + "; device ms " + ", ".join(
                            f"{k} {v:.1f}" for k, v in split["device_ms"].items())
                        + f"; device busy {split['device_busy']:.1%} [{card}]")
        del sep, model
        torch.cuda.empty_cache()
    want = {name: count * n_batches for name, count in per_batch.items()}
    if launches != want:
        raise AssertionError(f"{label} inference launches {launches}, want {want} "
                             f"({per_batch} per segment batch x {n_batches})")
    for kernel, form in fast_form.items():
        name = kernel.__name__
        if forms[name][form] != launches[name]:
            raise AssertionError(f"{label}: {name} launched {forms[name]} by form, want all "
                                 f"{launches[name]} in the {form} form")
    for name, counts in dtypes.items():
        # the network's dtype: bf16 only on --bf16 alone; K7's weight mode:
        # bf16 on --bf16 --int8
        dtype = "bfloat16" if bf16 and (quant is None or name == "int8_matmul") else "float32"
        if counts[dtype] != launches[name]:
            raise AssertionError(f"{label}: {name} launched {counts} by dtype, want all "
                                 f"{launches[name]} in {dtype}")
    summary = dict(model=label.split(" --")[0], quant=quant, bf16=bf16,
                   launches_by_dtype=dtypes,
                   track_secs=TRACK_SECS, segments=n_segments,
                   batches=n_batches, batch=MAIN_BATCH, wall_s=wall,
                   audio_s_per_s=TRACK_SECS / wall, max_memory_allocated=peak_mem,
                   weight_bytes_on_device=weight_bytes, weights_allocated=weights_allocated,
                   warm_load_s=load_s, warm_separate_s=warm_s,
                   warm_audio_s_per_s=TRACK_SECS / warm_s, profile=profile,
                   launches_by_form=forms, card=card,
                   **({"bag": True, "stems_against_models_alone": alone, "host_split": splits}
                      if bag else {}))
    log(f"main path ({label}): {TRACK_SECS} s track, {n_segments} segments in {n_batches} "
        f"batches of {MAIN_BATCH}: CLI wall {wall:.3f} s, {TRACK_SECS / wall:.3f} "
        f"audio-s/s, max_memory_allocated {peak_mem} B, launches {launches} (by form "
        f"{forms}, by dtype {dtypes}); "
        f"again in-process: load {load_s:.3f} s, separate {warm_s:.3f} s, "
        f"{TRACK_SECS / warm_s:.3f} audio-s/s; weights on the device {weight_bytes} B "
        f"({weights_allocated} B allocated)"
        + (f"; stem i against model i alone: {alone}" if bag else "") + f" [{card}]")
    return launches, n_batches, summary


def phase_int8_turns(card: str):
    """Warm separation of the 20 s track by htdemucs-4s with dense and
    with int8 weights, in one process, in turns (dense, int8, int8,
    dense, PAIR_REPS times): the end-to-end cost of --int8 on this card
    with the host's drift shared by both."""
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import from_state_dict, init_flat, quantize_int8
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator

    cfg, schema, _ = _family("htdemucs_4s")
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    opts = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337)
    track = synthetic_track(int(TRACK_SECS * SAMPLE_RATE))
    seps = {"dense": Separator(build_model(cfg, sd, "cuda"), cfg.num_sources, opts, "cuda"),
            "int8": Separator(build_model(cfg, quantize_int8(sd), "cuda"), cfg.num_sources,
                              opts, "cuda")}
    times = {name: [] for name in seps}
    for sep in seps.values():
        sep(track)
    for _ in range(PAIR_REPS):
        for name in ("dense", "int8", "int8", "dense"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            seps[name](track)
            torch.cuda.synchronize()
            times[name].append(time.monotonic() - t0)
    del seps
    torch.cuda.empty_cache()
    medians = {name: statistics.median(ts) for name, ts in times.items()}
    log(f"warm htdemucs-4s separation of {TRACK_SECS} s in turns: dense "
        f"{' '.join(f'{t:.4f}' for t in times['dense'])} s (median {medians['dense']:.4f}), "
        f"int8 {' '.join(f'{t:.4f}' for t in times['int8'])} s (median "
        f"{medians['int8']:.4f}); int8 / dense {medians['int8'] / medians['dense']:.3f} [{card}]")
    return dict(times_s=times, median_s=medians,
                int8_over_dense=medians["int8"] / medians["dense"])


# the long track of the host path, the --bf16 and the bag phases (8
# segments of 343980 samples: 4 segment batches of 2): 45 s, a quarter of
# the 180 s they once ran, to keep the run (with the multi-rank and the
# acceptance phases) inside its time limit
LONG_TRACK_SECS = 45.0
# the host side of the track path: htdemucs-4s on the long track and on the
# 20 s track, hdemucs_mmi on the 20 s track
HOST_CONFIGS = (("htdemucs_4s", LONG_TRACK_SECS), ("htdemucs_4s", TRACK_SECS),
                ("hdemucs_mmi", TRACK_SECS))
HOST_TURNS = 3                  # timed warm calls per mode, in turns
# each mode's options over the default path's (batch 2, shift offset 1337)
HOST_MODES = {
    "depth1": dict(pipeline_depth=1),
    "depth2": dict(pipeline_depth=2),
    "fused_exact": dict(fused_track=True, fused_buckets="exact"),
    "fused_geo": dict(fused_track=True, fused_buckets="geo"),
    "depth2_int16": dict(pipeline_depth=2, transfer_int16=True),
    "fused_int16": dict(fused_track=True, transfer_int16=True),
}
# fused against depth 1: max|diff| within 1e-5 x max(scale, 1) (the fused
# overlap-add sums in f32 on the device, the host's in f64)
FUSED_TOL = 1e-5
# the 20 s, 9 s and 31 s tracks of the CLI's directory run
CLI_DIR_SECS = (20.0, 9.0, 31.0)


def host_split(sep, track) -> dict:
    """One warm call of `sep`'s batched path at its pipeline depth, run
    here stage by stage as Separator._run_batched runs it: host time
    (perf_counter) of _prepare (normalize, shift, split), of the uploads
    (_place: into the pinned staging buffer, then the non-blocking copy),
    of the model's launches (_run_model), of starting the downloads
    (_start_download), of the waits (_fetch_device) and of _finish
    (int16 decode, overlap-add); device time (CUDA events) of the
    uploads, the model and the downloads (from the end of the model on
    the compute stream to the end of the copy on the side stream). A
    device time here is the span between two events on a stream: it
    includes the time the device waits there for the host (at depth 1 the
    upload's span includes the host's copy into the staging buffer)."""
    import collections

    import torch

    from demucs_tpu_torch.utils.progress import null_progress

    def event(stream):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    pc = time.perf_counter
    compute = torch.cuda.current_stream(sep.device)
    host = dict.fromkeys(("prepare", "upload", "launch", "download", "wait", "finish"), 0.0)
    torch.cuda.synchronize()
    t_all = pc()
    t = pc()
    batch, state = sep._prepare(track, null_progress)
    host["prepare"] = pc() - t
    bs, n = sep.options.batch_size, batch.shape[0]
    out = sep._host_buffer((n, sep.num_sources) + batch.shape[1:], sep._out_dtype())
    depth = max(1, sep.options.pipeline_depth)
    inflight: collections.deque = collections.deque()
    marks = []
    for i in range(0, n, bs):
        e0 = event(compute)
        t = pc()
        placed = sep._place(batch[i:i + bs])
        host["upload"] += pc() - t
        e1 = event(compute)
        t = pc()
        y = sep._run_model(placed)
        host["launch"] += pc() - t
        e2 = event(compute)
        t = pc()
        inflight.append(sep._start_download(y, out[i:i + bs]))
        host["download"] += pc() - t
        marks.append((e0, e1, e2, event(sep._copy_stream)))
        del y
        if len(inflight) >= depth:
            t = pc()
            sep._fetch_device(inflight.popleft())
            host["wait"] += pc() - t
    while inflight:
        t = pc()
        sep._fetch_device(inflight.popleft())
        host["wait"] += pc() - t
    t = pc()
    result = sep._finish(sep._postfetch(out.numpy()), state)
    host["finish"] = pc() - t
    wall = pc() - t_all
    device = {"upload": sum(a.elapsed_time(b) for a, b, _, _ in marks),
              "model": sum(b.elapsed_time(c) for _, b, c, _ in marks),
              "download": sum(c.elapsed_time(d) for _, _, c, d in marks)}
    return dict(wall_ms=1e3 * wall, host_ms={k: 1e3 * v for k, v in host.items()},
                device_ms=device, device_busy=sum(device.values()) / (1e3 * wall),
                batches=len(marks), result=result)


def wall_turns(fns: dict, rounds: int = HOST_TURNS) -> dict:
    """The functions of `fns` (warm; each ends on the host) timed in turns
    by the host clock, every call between two device synchronizations;
    {name: (median s, readings)}."""
    import torch

    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            readings[name].append(time.perf_counter() - t0)
    return {name: (statistics.median(r), r) for name, r in readings.items()}


def phase_host_path(card: str) -> dict:
    """The host side of the track path on the card. For each of
    HOST_CONFIGS, every mode of HOST_MODES: one first call (its peak
    memory and launch counts: per segment batch of 2, or per group of 2 of
    the fused pass, as `_family` gives them), its result held against
    depth 1 (depth 2: bit for bit; fused: FUSED_TOL; int16: the budget of
    tests/test_pipeline.py outside the clipped tail), then HOST_TURNS warm
    calls per mode in turns, and one profiled call (busy share); then the
    host split of one warm call at depth 1 and 2 (`host_split`)."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.pipeline import PCM16_TRANSFER_SCALE, ApplyOptions, Separator

    results = {}
    models = {}
    for kind, secs in HOST_CONFIGS:
        cfg, schema, per_batch = _family(kind)
        if kind not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[kind] = build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema),
                                       "cuda")
        model = models[kind]
        track = synthetic_track(int(secs * SAMPLE_RATE))
        std = float(track.mean(0).std(ddof=1))
        label = f"{kind} {secs:g} s"
        seps = {mode: Separator(model, cfg.num_sources,
                                ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337, **kw),
                                "cuda")
                for mode, kw in HOST_MODES.items()}
        rows, outs = {}, {}
        for mode, sep in seps.items():
            o = sep.options
            stride = int((1 - o.overlap) * o.segment_samples)
            n_true = track.shape[-1] + int(o.max_shift_secs * SAMPLE_RATE) - o.shift_offset
            n_seg = math.ceil(n_true / stride)
            if o.fused_track:
                n_seg = sep._bucket_nseg(n_seg)[0]
            calls = math.ceil(n_seg / MAIN_BATCH)
            for kernel in KERNELS:
                kernel.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs[mode] = sep(track)
            torch.cuda.synchronize()
            launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
            want = {name: count * calls for name, count in per_batch.items()}
            if launches != want:
                raise AssertionError(f"host path {label} {mode}: launches {launches}, want "
                                     f"{want} ({per_batch} x {calls} calls)")
            rows[mode] = dict(segments=n_seg, calls=calls, launches=launches,
                              peak_bytes=torch.cuda.max_memory_allocated())
        ref = outs["depth1"]
        scale = float(np.abs(ref).max())
        for mode, out in outs.items():
            if out.shape != ref.shape or not np.isfinite(out).all():
                raise AssertionError(f"host path {label} {mode}: shape {out.shape}, finite "
                                     f"{np.isfinite(out).all()}")
            err = np.abs(out - ref)
            check = dict(max_abs_diff=float(err.max()), scale=scale)
            if mode == "depth2":
                ok = np.array_equal(out, ref)
                check["rule"] = "bit-identical to depth 1"
            elif "int16" in mode:
                atol = 2.0 / PCM16_TRANSFER_SCALE * max(std, 1.0)
                over = float((err > atol).mean())
                inside = np.abs(ref) < 7.5 * std
                inside_max = float(err[inside].max()) if inside.any() else 0.0
                ok = over < 0.02 and inside_max <= atol
                check.update(rule=f"int16 budget {atol:.3e}: share over {over:.2e} < 0.02, "
                                  f"max below 7.5 std {inside_max:.3e}",
                             share_over=over, max_unclipped=inside_max)
            else:
                ok = mode == "depth1" or err.max() <= FUSED_TOL * max(scale, 1.0)
                check["rule"] = f"within {FUSED_TOL:g} x max(scale, 1) of depth 1"
            if not ok:
                raise AssertionError(f"host path {label} {mode} against depth 1: {check}")
            rows[mode]["check"] = check
        del outs
        turns = wall_turns({mode: (lambda s=sep: s(track)) for mode, sep in seps.items()})
        for mode, sep in seps.items():
            median, readings = turns[mode]
            prof = profile_device(lambda s=sep: s(track), f"one warm {label} {mode} call")
            rows[mode].update(median_s=median, times_s=readings,
                              spread_s=max(readings) - min(readings),
                              audio_s_per_s=secs / median, busy_share=prof.get("busy_share"),
                              device_ms=prof.get("device_ms"),
                              device_kernels=prof.get("device_kernels"))
            log(f"host path {label} {mode}: median {median:.4f} s "
                f"({' '.join(f'{t:.4f}' for t in readings)}), {secs / median:.2f} audio-s/s, "
                f"busy {_pct(prof.get('busy_share'))}, calls {rows[mode]['calls']}, launches "
                f"{rows[mode]['launches']}, peak {rows[mode]['peak_bytes'] / 1e9:.2f} GB, "
                f"check {rows[mode]['check']} [{card}]")
        split = {}
        for mode in ("depth1", "depth2"):
            s = host_split(seps[mode], track)
            if not np.array_equal(s.pop("result"), ref):
                raise AssertionError(f"host split {label} {mode}: differs from the call")
            split[mode] = s
            log(f"host split {label} {mode}: wall {s['wall_ms']:.1f} ms; host ms "
                + ", ".join(f"{k} {v:.1f}" for k, v in s["host_ms"].items())
                + "; device ms " + ", ".join(f"{k} {v:.1f}" for k, v in s["device_ms"].items())
                + f"; {s['batches']} batches, device busy {s['device_busy']:.1%} [{card}]")
        results[label] = dict(modes=rows, split=split, track_secs=secs, card=card)
        del seps
    return results


# --bf16 against f32 on the long htdemucs-4s track: the default path
# (pipeline depth 2) and the fused pass, in both dtypes, timed in turns
BF16_MODES = {"f32_default": (False, {}), "bf16_default": (True, {}),
              "bf16_fused": (True, dict(fused_track=True)),
              "f32_fused": (False, dict(fused_track=True))}


def phase_bf16_long_track(card: str) -> dict:
    """htdemucs-4s on the LONG_TRACK_SECS track with --bf16 weights, on the default
    path and the fused pass, beside the same in f32: launch counts per
    segment batch (or group of 2) asserted, every K1 and K5 launch in its
    bf16 form, the bf16 fused result held against the bf16 default path
    (1e-2 of max(scale, 1)) and each bf16 result against its f32 twin mode
    (relative norm under the JAX package's 0.08), peak memory, HOST_TURNS
    warm calls per mode in turns, one profiled call each (busy share,
    device time by class)."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.ops.cuda import KERNELS, dconv_sub_block, flash_mha
    from demucs_tpu_torch.params import cast_state_dict, from_state_dict, init_flat
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator

    cfg, schema, per_batch = _family("htdemucs_4s")
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    models = {False: build_model(cfg, sd, "cuda"),
              True: build_model(cfg, cast_state_dict(sd, torch.bfloat16), "cuda")}
    secs = LONG_TRACK_SECS
    track = synthetic_track(int(secs * SAMPLE_RATE))
    seps = {mode: Separator(models[b], cfg.num_sources,
                            ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337, **kw), "cuda")
            for mode, (b, kw) in BF16_MODES.items()}
    rows, outs = {}, {}
    for mode, sep in seps.items():
        o = sep.options
        stride = int((1 - o.overlap) * o.segment_samples)
        n_seg = math.ceil((track.shape[-1] + int(o.max_shift_secs * SAMPLE_RATE)
                           - o.shift_offset) / stride)
        if o.fused_track:
            n_seg = sep._bucket_nseg(n_seg)[0]
        calls = math.ceil(n_seg / MAIN_BATCH)
        for kernel in KERNELS:
            kernel.launches = 0
        for kernel in (flash_mha, dconv_sub_block):
            kernel.launches_by_dtype = dict.fromkeys(kernel.launches_by_dtype, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs[mode] = sep(track)
        torch.cuda.synchronize()
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        want = {name: count * calls for name, count in per_batch.items()}
        dtype = "bfloat16" if mode.startswith("bf16") else "float32"
        if launches != want or any(k.launches_by_dtype[dtype] != k.launches
                                   for k in (flash_mha, dconv_sub_block)):
            raise AssertionError(f"--bf16 {secs:g} s {mode}: launches {launches} (K1 "
                                 f"{flash_mha.launches_by_dtype}, K5 "
                                 f"{dconv_sub_block.launches_by_dtype}), want {want} in {dtype}")
        rows[mode] = dict(segments=n_seg, calls=calls, launches=launches,
                          peak_bytes=torch.cuda.max_memory_allocated())
    checks = {}
    for mode in ("bf16_default", "bf16_fused"):
        out = outs[mode]
        if out.shape != outs["f32_default"].shape or not np.isfinite(out).all():
            raise AssertionError(f"--bf16 {secs:g} s {mode}: shape {out.shape}, finite "
                                 f"{np.isfinite(out).all()}")
        twin = outs[mode.replace("bf16", "f32")]
        rel = float(np.linalg.norm(out - twin) / np.linalg.norm(twin))
        checks[mode] = dict(rel_to_f32=rel)
        if not rel < 0.08:
            raise AssertionError(f"--bf16 {secs:g} s {mode}: {rel} of the f32 result, over 0.08")
    diff = float(np.abs(outs["bf16_fused"] - outs["bf16_default"]).max())
    scale = float(np.abs(outs["bf16_default"]).max())
    checks["fused_vs_default"] = dict(max_abs_diff=diff, scale=scale)
    if not diff <= TOL["bfloat16"] * max(scale, 1.0):
        raise AssertionError(f"--bf16 {secs:g} s fused vs default: {diff} (scale {scale})")
    del outs
    turns = wall_turns({mode: (lambda s=sep: s(track)) for mode, sep in seps.items()})
    for mode, sep in seps.items():
        median, readings = turns[mode]
        prof = profile_device(lambda s=sep: s(track), f"one warm {secs:g} s {mode} call")
        rows[mode].update(median_s=median, times_s=readings,
                          audio_s_per_s=secs / median, busy_share=prof.get("busy_share"),
                          device_ms=prof.get("device_ms"), by_class_ms=prof.get("by_class_ms"))
        log(f"--bf16 {secs:g} s {mode}: median {median:.4f} s "
            f"({' '.join(f'{t:.4f}' for t in readings)}), {secs / median:.2f} audio-s/s, busy {_pct(prof.get('busy_share'))}, device "
            f"{_ms(prof.get('device_ms'))} ms, calls {rows[mode]['calls']}, peak "
            f"{rows[mode]['peak_bytes'] / 1e9:.2f} GB [{card}]")
    log(f"--bf16 {secs:g} s checks: {checks}")
    del seps, models
    torch.cuda.empty_cache()
    return dict(modes=rows, checks=checks, track_secs=secs, card=card)


def phase_reference_bf16(kind: str, quant: str | None = None) -> dict:
    """--bf16 (and --bf16 --int8) on the GPU against the port on the CPU,
    one short segment. --bf16: the GPU's bf16 result no further from the
    CPU's bf16 result (norms) than the two devices' f32 results plus twice
    the CPU's own bf16 error against f32 (hdemucs_mmi's f32 results
    differ by ~0.8% of their norm: at random weights its spectrum is
    mostly its mean, whose inverse FFT cancels to a residue), and within
    0.08 (relative norm) of the GPU's f32 result.
    --bf16 --int8, an f32 network: within SEP_REF_TOL of the CPU, as the
    f32 models."""
    import numpy as np
    import torch

    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import (cast_state_dict, from_state_dict, init_flat,
                                         quantize_int8)

    cfg, schema, _ = _family(kind, quant)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    modes = {"bf16": (cast_state_dict(sd, torch.bfloat16), torch.float32)} if quant is None \
        else {"bf16": (quantize_int8(sd), torch.bfloat16)}
    modes["f32"] = (sd, torch.float32)
    outs = {}
    for mode, (weights, quant_dtype) in modes.items():
        for device in ("cuda", "cpu"):
            model = build_model(cfg, weights, device, quant_dtype=quant_dtype)
            with torch.inference_mode():
                outs[mode, device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
            del model
    gpu, cpu = outs["bf16", "cuda"], outs["bf16", "cpu"]
    label = f"{kind} --bf16" + (f" --{quant}" if quant else "")
    if not np.isfinite(gpu).all():
        raise AssertionError(f"GPU {label}: not finite")
    norm = np.linalg.norm
    result = dict(gpu_vs_cpu=float(norm(gpu - cpu)),
                  cpu_bf16_vs_f32=float(norm(cpu - outs["f32", "cpu"])),
                  f32_gpu_vs_cpu=float(norm(outs["f32", "cuda"] - outs["f32", "cpu"])),
                  gpu_vs_gpu_f32_rel=float(norm(gpu - outs["f32", "cuda"])
                                           / norm(outs["f32", "cuda"])),
                  max_abs_diff=float(np.abs(gpu - cpu).max()), scale=float(np.abs(cpu).max()))
    if quant is None:
        ok = (result["gpu_vs_cpu"] <= result["f32_gpu_vs_cpu"] + 2 * result["cpu_bf16_vs_f32"]
              and result["gpu_vs_gpu_f32_rel"] < 0.08)
        rule = ("||gpu - cpu|| <= ||gpu_f32 - cpu_f32|| + 2 ||cpu_bf16 - cpu_f32||, "
                "||gpu - gpu_f32|| < 0.08 ||gpu_f32||")
    else:
        ok = result["max_abs_diff"] < SEP_REF_TOL * max(result["scale"], 1.0)
        rule = f"max|gpu - cpu| < {SEP_REF_TOL:g} x max(scale, 1) (an f32 network)"
    result["rule"] = rule
    if not ok:
        raise AssertionError(f"GPU vs CPU {label}: {result}")
    log(f"reference: {label} (1, 2, 32768) GPU vs CPU: {result}")
    return result


def phase_stage_timer(card: str) -> dict:
    """fine_progress on the card: one warm separation of the 20 s track by
    htdemucs-4s and by hdemucs_mmi, reported through StageTimer; the device
    ms of each stage (CUDA events between the marks), summed over the
    segment batches."""
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.utils.profiling import StageTimer

    track = synthetic_track(int(TRACK_SECS * SAMPLE_RATE))
    results = {}
    for kind, n_marks in (("htdemucs_4s", 26), ("hdemucs_mmi", 22)):
        cfg, schema, _ = _family(kind)
        model = build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda")
        sep = Separator(model, cfg.num_sources,
                        ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337,
                                     fine_progress=True), "cuda")
        sep(track)
        timer = StageTimer()
        t0 = time.perf_counter()
        sep(track, progress=timer)
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in timer.report().splitlines()]
        stages = [x for x in lines if "device_s" in x]
        n_batches = sum(x["message"].startswith("segments") for x in lines)
        if len(stages) != n_marks * n_batches:
            raise AssertionError(f"{kind}: {len(stages)} stage marks with a device time, "
                                 f"want {n_marks} x {n_batches} batches")
        per_stage: dict[str, float] = {}
        for x in stages:
            per_stage[x["message"]] = per_stage.get(x["message"], 0.0) + 1e3 * x["device_s"]
        total = sum(per_stage.values())
        log(f"stage timer, {kind}, one warm {TRACK_SECS:g} s call with fine_progress: wall "
            f"{wall:.3f} s, {n_batches} batches, device ms between marks {total:.1f} [{card}]")
        for msg, ms in per_stage.items():
            log(f"  {msg:>30} {ms:8.2f} ms  {ms / total:6.1%}")
        results[kind] = dict(wall_s=wall, batches=n_batches, device_ms_by_stage=per_stage,
                             device_ms=total)
        del sep, model
        torch.cuda.empty_cache()
    return results


def phase_cli_host(card: str) -> dict:
    """The CLI's host-path options: htdemucs-4s on the 20 s track with
    --fused --transfer-int16, then on a directory of three WAVs (20 s, 9 s,
    31 s) with the default options (one global batch, separate_many); every
    stem finite and of its track's length."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.params import init_flat, write_ggml

    cfg, schema, _ = _family("htdemucs_4s")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model_path = tmp / "htdemucs_4s.bin"
        write_ggml(model_path, "htdemucs_4s", init_flat(schema, seed=0))
        tracks = tmp / "tracks"
        tracks.mkdir()
        lengths = {}
        for k, secs in enumerate(CLI_DIR_SECS):
            n = int(secs * SAMPLE_RATE)
            audio.write_wav(tracks / f"track{k}.wav", synthetic_track(n))
            lengths[f"track{k}"] = n
        runs = (("--fused --transfer-int16", [str(tracks / "track0.wav"), str(tmp / "one"),
                                              "--fused", "--transfer-int16"],
                 {"": lengths["track0"]}),
                ("directory", [str(tracks), str(tmp / "dir")], lengths))
        for what, args, want in runs:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            rc = cli.main([str(model_path)] + args + ["--device", "cuda", "--batch",
                                                      str(MAIN_BATCH), "--offset", "1337"])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            if rc != 0:
                raise RuntimeError(f"cli.main ({what}) exited {rc}")
            outdir = Path(args[1])
            for sub, n in want.items():
                for i, name in enumerate(cfg.sources):
                    stem, rate = audio.read_wav(outdir / sub / f"target_{i}_{name}.wav")
                    if rate != SAMPLE_RATE or stem.shape != (2, n) or \
                            not np.isfinite(stem).all():
                        raise AssertionError(f"CLI {what}: {sub}/{name}: rate {rate}, shape "
                                             f"{stem.shape}, finite {np.isfinite(stem).all()}")
            secs = sum(want.values()) / SAMPLE_RATE
            results[what] = dict(wall_s=wall, audio_s=secs, tracks=len(want))
            log(f"CLI {what}: {len(want)} track(s), {secs:.1f} s of audio in {wall:.3f} s "
                f"(cold CLI, model load included) [{card}]")
    return results


# --- the fine-tuned bag and streaming ----------------------------------------------

def _bag_model(quant: str | None = None):
    """The bag of bag_dir()'s four models on the card, built as the CLI
    builds it."""
    import torch

    from demucs_tpu_torch.models import build_bag
    from demucs_tpu_torch.params import load_model_params, quantize_int8

    cfg, schema, _ = _family("htdemucs_4s")
    sds = [load_model_params(bag_dir() / f"htdemucs_ft_{stem}.bin")[1] for stem in cfg.sources]
    if quant == "int8":
        sds = [quantize_int8(sd) for sd in sds]
    return build_bag(cfg, sds, "cuda"), cfg


def phase_bag_long_track(card: str) -> dict:
    """The bag on the LONG_TRACK_SECS track: the default path (pipeline depth 2) and
    the fused pass, launch counts per segment batch (or group of 2)
    asserted (four models' each), the fused result within FUSED_TOL of the
    default path's, peak memory, HOST_TURNS warm calls each in turns, one
    profiled call each (busy share, device time by class); then one call of
    SequentialBagSeparator's fused form, held against the same and bit for
    bit against Separator(BagOfModels)'s fused pass, which it is."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.pipeline import ApplyOptions, SequentialBagSeparator, Separator

    bag, cfg = _bag_model()
    _, _, per_batch = _family("htdemucs_4s")
    per_batch = {name: 4 * count for name, count in per_batch.items()}
    secs = LONG_TRACK_SECS
    track = synthetic_track(int(secs * SAMPLE_RATE))
    modes = {"default": {}, "fused": dict(fused_track=True)}
    seps = {mode: Separator(bag, cfg.num_sources,
                            ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337, **kw), "cuda")
            for mode, kw in modes.items()}
    seps["sequential_fused"] = SequentialBagSeparator(
        list(bag.models), cfg.num_sources,
        ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337, fused_track=True), "cuda")
    rows, outs = {}, {}
    for mode, sep in seps.items():
        o = sep.options
        stride = int((1 - o.overlap) * o.segment_samples)
        n_seg = math.ceil((track.shape[-1] + int(o.max_shift_secs * SAMPLE_RATE)
                           - o.shift_offset) / stride)
        if o.fused_track:
            n_seg = sep._bucket_nseg(n_seg)[0]
        calls = math.ceil(n_seg / MAIN_BATCH)
        for kernel in KERNELS:
            kernel.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[mode] = sep(track)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        want = {name: count * calls for name, count in per_batch.items()}
        if launches != want:
            raise AssertionError(f"bag {secs:g} s {mode}: launches {launches}, want {want}")
        rows[mode] = dict(segments=n_seg, calls=calls, launches=launches, first_s=first_s,
                          peak_bytes=torch.cuda.max_memory_allocated())
    ref = outs["default"]
    scale = float(np.abs(ref).max())
    checks = {}
    if not np.array_equal(outs["sequential_fused"], outs["fused"]):
        raise AssertionError(f"bag {secs:g} s: SequentialBagSeparator's fused form differs from "
                             "Separator(BagOfModels)'s fused pass")
    for mode in ("fused", "sequential_fused"):
        out = outs[mode]
        diff = float(np.abs(out - ref).max()) if out.shape == ref.shape else float("inf")
        checks[mode] = dict(max_abs_diff=diff, scale=scale)
        if not (np.isfinite(out).all() and diff <= FUSED_TOL * max(scale, 1.0)):
            raise AssertionError(f"bag {secs:g} s {mode} against the default path: {checks[mode]}")
    del outs
    timed = {mode: seps[mode] for mode in modes}
    turns = wall_turns({mode: (lambda s=sep: s(track)) for mode, sep in timed.items()})
    for mode, sep in timed.items():
        median, readings = turns[mode]
        prof = profile_device(lambda s=sep: s(track), f"one warm bag {secs:g} s {mode} call")
        rows[mode].update(median_s=median, times_s=readings,
                          spread_s=max(readings) - min(readings),
                          audio_s_per_s=secs / median, busy_share=prof.get("busy_share"),
                          device_ms=prof.get("device_ms"), by_class_ms=prof.get("by_class_ms"))
        log(f"bag {secs:g} s {mode}: median {median:.4f} s "
            f"({' '.join(f'{t:.4f}' for t in readings)}), {secs / median:.2f} audio-s/s, "
            f"busy {_pct(prof.get('busy_share'))}, device {_ms(prof.get('device_ms'))} ms, "
            f"calls {rows[mode]['calls']}, peak {rows[mode]['peak_bytes'] / 1e9:.2f} GB [{card}]")
    seq = rows["sequential_fused"]
    log(f"bag {secs:g} s SequentialBagSeparator fused: one call {seq['first_s']:.4f} s (first, cold "
        f"for its plan), peak {seq['peak_bytes'] / 1e9:.2f} GB; checks {checks} [{card}]")
    del seps, bag
    torch.cuda.empty_cache()
    return dict(modes=rows, checks=checks, track_secs=secs, card=card)


def phase_bag_cli_host(card: str) -> dict:
    """The bag through the CLI's host options: --ft-dir with --fused
    --transfer-int16 on a directory of two WAVs (20 s, 9 s): one folder per
    track, every stem finite and of its track's length, four models'
    launches per group of 2 segments."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.pipeline import ApplyOptions

    cfg, _, per_batch = _family("htdemucs_4s")
    lengths = {"track0": int(TRACK_SECS * SAMPLE_RATE), "track1": int(9.0 * SAMPLE_RATE)}
    o = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337)
    stride = int((1 - o.overlap) * o.segment_samples)
    # the fused pass's groups of MAIN_BATCH segments (exact buckets)
    groups = sum(math.ceil(math.ceil((n + int(o.max_shift_secs * SAMPLE_RATE) - 1337)
                                     / stride) / MAIN_BATCH) for n in lengths.values())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tracks = tmp / "tracks"
        tracks.mkdir()
        for name, n in lengths.items():
            audio.write_wav(tracks / f"{name}.wav", synthetic_track(n))
        for kernel in KERNELS:
            kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(["--ft-dir", str(bag_dir()), str(tracks), str(tmp / "out"),
                       "--device", "cuda", "--batch", str(MAIN_BATCH), "--offset", "1337",
                       "--fused", "--transfer-int16"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        if rc != 0:
            raise RuntimeError(f"cli.main (--ft-dir --fused --transfer-int16, directory) "
                               f"exited {rc}")
        want = {name: 4 * count * groups for name, count in per_batch.items()}
        if launches != want:
            raise AssertionError(f"bag CLI --fused --transfer-int16: launches {launches}, "
                                 f"want {want}")
        for name, n in lengths.items():
            for i, stem in enumerate(cfg.sources):
                x, rate = audio.read_wav(tmp / "out" / name / f"target_{i}_{stem}.wav")
                if rate != SAMPLE_RATE or x.shape != (2, n) or not np.isfinite(x).all():
                    raise AssertionError(f"bag CLI directory {name}/{stem}: rate {rate}, "
                                         f"shape {x.shape}, finite {np.isfinite(x).all()}")
    secs = sum(lengths.values()) / SAMPLE_RATE
    log(f"bag CLI --fused --transfer-int16 on a directory: 2 tracks, {secs:.1f} s of audio in "
        f"{wall:.3f} s (cold CLI, four models' load included), launches {launches} [{card}]")
    return dict(wall_s=wall, audio_s=secs, tracks=2, launches=launches)


STREAM_CHUNK_SECS = 1.0
STREAM_TOL = 1e-5   # the stream against the offline path, of max(scale, 1)


def stream_calls(n: int, chunk: int, segment: int, stride: int, max_batch: int):
    """The device calls and segments of a stream of n samples pushed `chunk`
    at a time then flushed, as StreamingSeparator makes them: each push's
    ready segments in groups of max_batch, then the flush's tails."""
    calls = segments = nxt = 0
    for pos in range(0, n, chunk):
        total, ready = min(pos + chunk, n), 0
        while nxt + segment <= total:
            ready, nxt = ready + 1, nxt + stride
        calls, segments = calls + math.ceil(ready / max_batch), segments + ready
    tails = 0
    while nxt < n:
        tails, nxt = tails + 1, nxt + stride
    return calls + math.ceil(tails / max_batch), segments + tails


def phase_stream(card: str, kind: str) -> dict:
    """Streaming: `kind` (htdemucs_4s, hdemucs_mmi, or "bag", the
    fine-tuned bag) through the port's CLI with --stream on the 20 s track
    in 1 s chunks at --batch 2: launches per device call asserted, stems
    finite and of the track's length. Then in-process on the same model:
    the stream with the track's statistics against the offline Separator
    without shift (STREAM_TOL), its realtime factor, and the latency of
    the emitted samples in audio seconds (the audio fed when a sample is
    emitted, less its position) against one segment plus one stride."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE, SEGMENT_SAMPLES
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import init_flat, write_ggml, from_state_dict
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.streaming import StreamingSeparator

    bag = kind == "bag"
    cfg, schema, per_batch = _family("htdemucs_4s" if bag else kind)
    if bag:
        per_batch = {name: 4 * count for name, count in per_batch.items()}
    n = int(TRACK_SECS * SAMPLE_RATE)
    chunk = int(STREAM_CHUNK_SECS * SAMPLE_RATE)
    stride = int(0.75 * SEGMENT_SAMPLES)
    calls, segments = stream_calls(n, chunk, SEGMENT_SAMPLES, stride, MAIN_BATCH)
    track = synthetic_track(n)
    label = "htdemucs_ft bag" if bag else kind
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if bag:
            model_args = ["--ft-dir", str(bag_dir())]
        else:
            write_ggml(tmp / f"{kind}.bin", kind, init_flat(schema, seed=0))
            model_args = [str(tmp / f"{kind}.bin")]
        audio.write_wav(tmp / "mix.wav", track)
        for kernel in KERNELS:
            kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(model_args + [str(tmp / "mix.wav"), str(tmp / "out"), "--device", "cuda",
                                    "--stream", "--stream-chunk-secs", str(STREAM_CHUNK_SECS),
                                    "--batch", str(MAIN_BATCH)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {kernel.__name__: kernel.launches for kernel in KERNELS}
        if rc != 0:
            raise RuntimeError(f"cli.main --stream ({label}) exited {rc}")
        want = {name: count * calls for name, count in per_batch.items()}
        if launches != want:
            raise AssertionError(f"--stream {label}: launches {launches}, want {want} "
                                 f"({per_batch} per call x {calls} calls)")
        for i, name in enumerate(cfg.sources):
            x, rate = audio.read_wav(tmp / "out" / f"target_{i}_{name}.wav")
            if rate != SAMPLE_RATE or x.shape != (2, n) or not np.isfinite(x).all():
                raise AssertionError(f"--stream {label} {name}: rate {rate}, shape {x.shape}, "
                                     f"finite {np.isfinite(x).all()}")

    if bag:
        model, _ = _bag_model()
    else:
        model = build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda")
    mono = track.mean(0)
    stats = (float(mono.mean()), float(mono.std(ddof=1)))
    stream = StreamingSeparator(model, cfg.num_sources, stats=stats, max_batch=MAIN_BATCH)

    def run_stream():
        outs, lat, emitted = [], [], 0
        for pos in range(0, n, chunk):
            out = stream.push(track[:, pos:pos + chunk])
            if out.shape[-1]:
                # the first sample of this emission waited longest
                lat.append((min(pos + chunk, n) - emitted) / SAMPLE_RATE)
                outs.append(out)
                emitted += out.shape[-1]
        outs.append(stream.flush())
        return np.concatenate([o for o in outs if o.shape[-1]], -1), lat

    run_stream()   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, lat = run_stream()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    offline = Separator(model, cfg.num_sources,
                        ApplyOptions(batch_size=MAIN_BATCH, shift_offset=0,
                                     max_shift_secs=0.0), "cuda")(track)
    diff = float(np.abs(got - offline).max()) if got.shape == offline.shape else float("inf")
    scale = float(np.abs(offline).max())
    if not (np.isfinite(got).all() and diff <= STREAM_TOL * max(scale, 1.0)):
        raise AssertionError(f"--stream {label} against the offline path: max diff {diff}, "
                             f"scale {scale}")
    bound = (SEGMENT_SAMPLES + stride) / SAMPLE_RATE
    if max(lat) > bound + STREAM_CHUNK_SECS:
        raise AssertionError(f"--stream {label}: latency {max(lat)} s over the bound {bound} s "
                             f"plus one chunk")
    del stream, model
    torch.cuda.empty_cache()
    summary = dict(model=label, track_secs=TRACK_SECS, chunk_secs=STREAM_CHUNK_SECS,
                   max_batch=MAIN_BATCH, calls=calls, segments=segments, launches=launches,
                   cli_wall_s=wall, cli_realtime=TRACK_SECS / wall, warm_stream_s=stream_s,
                   realtime=TRACK_SECS / stream_s, first_latency_s=lat[0],
                   max_latency_s=max(lat), latency_bound_s=bound,
                   against_offline=dict(max_abs_diff=diff, scale=scale), card=card)
    log(f"--stream {label}: {TRACK_SECS} s in {STREAM_CHUNK_SECS} s chunks, {segments} "
        f"segments in {calls} calls of up to {MAIN_BATCH}; launches {launches}; CLI wall "
        f"{wall:.3f} s ({TRACK_SECS / wall:.2f}x realtime, model load included); warm stream "
        f"{stream_s:.3f} s ({TRACK_SECS / stream_s:.2f}x realtime); first emitted sample after "
        f"{lat[0]:.2f} s of audio, at most {max(lat):.2f} s (bound {bound:.2f} s); against "
        f"offline max|diff| {diff:.3e} (scale {scale:.3e}) [{card}]")
    return summary


def phase_reference_bag() -> dict:
    """The bag on the GPU (CUDA kernels) and on the CPU (plain twins) on a
    one-segment track (30000 samples, 32768-sample segments, shift offset
    1337) through Separator: within SEP_REF_TOL x max(scale, 1)."""
    import numpy as np
    import torch

    from demucs_tpu_torch.models import build_bag
    from demucs_tpu_torch.params import load_model_params
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator

    cfg, _, _ = _family("htdemucs_4s")
    sds = [load_model_params(bag_dir() / f"htdemucs_ft_{stem}.bin")[1] for stem in cfg.sources]
    track = (np.random.default_rng(42).standard_normal((2, 30000)) * 0.1).astype(np.float32)
    opts = ApplyOptions(segment_samples=32768, batch_size=1, shift_offset=1337)
    outs = {}
    for device in ("cuda", "cpu"):
        bag = build_bag(cfg, sds, device)
        outs[device] = Separator(bag, cfg.num_sources, opts, device)(track)
        del bag
    torch.cuda.empty_cache()
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    scale = float(np.abs(outs["cpu"]).max())
    if not (np.isfinite(outs["cuda"]).all() and diff < SEP_REF_TOL * max(scale, 1.0)):
        raise AssertionError(f"GPU vs CPU bag: max diff {diff}, scale {scale}")
    log(f"reference: htdemucs_ft bag, one 32768-sample segment, GPU vs CPU max|diff| "
        f"{diff:.3e} (scale {scale:.3e}, tolerance {SEP_REF_TOL:g} * max(scale, 1))")
    return dict(max_abs_diff=diff, scale=scale)


# --- serving: sessions, the feeder, the HTTP server, the export ----------------------

SERVE_TIMED = 3          # timed /separate requests per server, median
SERVE_CONCURRENT = 4     # simultaneous uploads to a --no-fused server
# the concurrent uploads: 15 s gives 3 segments a track (2 device calls one
# at a time, 1.5 when shared at MAIN_BATCH)
SERVE_CONCURRENT_SECS = 15.0
EXPORT_TOL = 1e-6        # an exported program against the live session, of its scale
SERVE_SOCKET_TIMEOUT = 120   # s: a stalled request fails the phase instead of hanging it


def _serve(**kw):
    """A server of demucs_tpu_torch/tools/serve.py on a free port, serving
    from a thread -> (server, host, port)."""
    import threading

    from demucs_tpu_torch.tools.serve import make_server

    srv = make_server(port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, *srv.server_address


def _stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()
    srv.feeder.close()


def _http_separate(host: str, port: int, body: bytes) -> bytes:
    import urllib.request

    req = urllib.request.Request(f"http://{host}:{port}/separate", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=SERVE_SOCKET_TIMEOUT) as r:
        if r.status != 200 or r.headers["Content-Type"] != "application/zip":
            raise AssertionError(f"/separate answered {r.status} {r.headers['Content-Type']}")
        return r.read()


def _zip_stems(blob: bytes, sources) -> "np.ndarray":
    """A /separate response's WAVs -> (S, 2, n), names checked."""
    import zipfile

    import numpy as np

    from demucs_tpu_torch import audio

    out = []
    with zipfile.ZipFile(io.BytesIO(blob)) as z, tempfile.TemporaryDirectory() as tmp:
        names = sorted(z.namelist())
        want = [f"target_{i}_{s}.wav" for i, s in enumerate(sources)]
        if names != want:
            raise AssertionError(f"/separate zip holds {names}, want {want}")
        for name in names:
            (Path(tmp) / name).write_bytes(z.read(name))
            out.append(audio.read_wav(Path(tmp) / name)[0])
    return np.stack(out)


def _http_stream(host: str, port: int, track, chunk: int):
    """POST /stream: the track in chunks of `chunk` frames, sent from a
    thread while this one reads the chunked response (a client that sends
    everything first can deadlock once both socket buffers fill) ->
    (S, 2, n) stems. On a raw socket: http.client's connection hands its
    socket to the response once the server's headers say it will close."""
    import http.client
    import socket
    import threading

    import numpy as np

    sock = socket.create_connection((host, port), timeout=SERVE_SOCKET_TIMEOUT)
    sock.sendall(f"POST /stream HTTP/1.1\r\nHost: {host}:{port}\r\n"
                 "Transfer-Encoding: chunked\r\n\r\n".encode())
    frames = np.ascontiguousarray(track.T.astype("<f4"))
    errors = []

    def send():
        try:
            for i in range(0, frames.shape[0], chunk):
                b = frames[i:i + chunk].tobytes()
                sock.sendall(b"%X\r\n" % len(b) + b + b"\r\n")
            sock.sendall(b"0\r\n\r\n")
        except OSError as e:
            errors.append(e)

    sender = threading.Thread(target=send)
    sender.start()
    try:
        resp = http.client.HTTPResponse(sock)
        resp.begin()
        body = resp.read()
    finally:
        sender.join()
        sock.close()
    if errors or resp.status != 200:
        raise AssertionError(f"/stream: status {resp.status}, send errors {errors}")
    S = len(resp.headers["X-Sources"].split(","))
    return np.frombuffer(body, "<f4").reshape(-1, S, 2).transpose(1, 2, 0)


def phase_serving(card: str) -> dict:
    """Serving on the card (demucs_tpu_torch/serving.py, service.py,
    tools/serve.py) for full-width htdemucs-4s (a seed-0 ggml written by
    the port's write_ggml), hdemucs_mmi and the fine-tuned bag (bag_dir()):

      * the session's demix_track of the 20 s track against a direct
        Separator with the same options (bit for bit), and a GPU session
        against a CPU one on a one-segment track (30000 samples,
        32768-sample segments; SEP_REF_TOL x max(scale, 1));
      * a server (fused default, int16 transfers) in a thread on port 0:
        /health, /separate of the 20 s WAV (one warm request, then
        SERVE_TIMED timed: median latency; launches per fused pass
        asserted), /stream of the 20 s track in 1 s chunks (launches per
        feeder call asserted, stems within the int16 budget of the
        session's offline stream);
      * a --no-fused server: SERVE_CONCURRENT uploads of a 15 s track one
        after another, then at once (wall times, device calls, the busy
        share of one more concurrent round under torch.profiler); the
        concurrent round makes fewer device calls than the serial one, its
        stems equal the serial ones within the int16 budget of
        tests/test_pipeline.py, and the kernels' launches are the
        per-batch counts times the feeder's device calls;
      * for htdemucs-4s and hdemucs_mmi, export_program (B = 1; the
        track program is held on the CPU, tests/test_torch_serving_export.py,
        its trace being the longest step here): the graph calls the
        demucs_tpu_torch:: custom ops, and the loaded program
        runs on the card, launching the kernels, within EXPORT_TOL of the
        live session's scale under torch's default flags (cuDNN's TF32
        on: the loaded program turns it off for its call, as the live
        model does).
    """
    import numpy as np
    import torch

    from demucs_tpu_torch import audio
    from demucs_tpu_torch.config import SAMPLE_RATE, SEGMENT_SAMPLES
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import init_flat, write_ggml
    from demucs_tpu_torch.pipeline import PCM16_TRANSFER_SCALE, ApplyOptions, Separator
    from demucs_tpu_torch.serving import BagDemixSession, DemixSession
    from demucs_tpu_torch.streaming import StreamingSeparator

    def zero():
        for kernel in KERNELS:
            kernel.launches = 0

    def counts():
        return {kernel.__name__: kernel.launches for kernel in KERNELS}

    def budget(track):
        """The int16 transfer's budget (tests/test_pipeline.py) and the
        response WAV's PCM16 error."""
        return 2.0 / PCM16_TRANSFER_SCALE * max(track.mean(0).std(ddof=1), 1.0) + 1.5 / 32767

    n = int(TRACK_SECS * SAMPLE_RATE)
    track = synthetic_track(n)
    conc_track = synthetic_track(int(SERVE_CONCURRENT_SECS * SAMPLE_RATE))
    short = (np.random.default_rng(42).standard_normal((2, 30000)) * 0.1).astype(np.float32)
    chunk = int(STREAM_CHUNK_SECS * SAMPLE_RATE)
    summary = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        audio.write_wav(tmp / "mix.wav", track)
        audio.write_wav(tmp / "conc.wav", conc_track)
        body, conc_body = (tmp / "mix.wav").read_bytes(), (tmp / "conc.wav").read_bytes()
        for kind in ("htdemucs_4s", "hdemucs_mmi", "bag"):
            t_kind = time.monotonic()
            bag = kind == "bag"
            cfg, schema, per_batch = _family("htdemucs_4s" if bag else kind)
            if bag:
                per_batch = {name: 4 * count for name, count in per_batch.items()}
                source = dict(ft_dir=str(bag_dir()))
                make_session = lambda device: BagDemixSession(bag_dir(), device=device)  # noqa: E731
            else:
                write_ggml(tmp / f"{kind}.bin", kind, init_flat(schema, seed=0))
                source = dict(model_path=str(tmp / f"{kind}.bin"))
                make_session = lambda device: DemixSession(  # noqa: E731
                    (tmp / f"{kind}.bin").read_bytes(), device=device)
            out = {}

            # the session against a direct Separator, and against the CPU
            sess = make_session("cuda")  # the default device is the card
            opts = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337)
            est = sess.demix_track(track, opts)
            direct = Separator(sess.model, cfg.num_sources, opts, "cuda")(track)
            if not (est.shape == (cfg.num_sources, 2, n) and np.isfinite(est).all()
                    and np.array_equal(est, direct)):
                raise AssertionError(f"serving {kind}: demix_track differs from a direct "
                                     f"Separator by {np.abs(est - direct).max()}")
            ref_opts = ApplyOptions(segment_samples=32768, batch_size=1, shift_offset=1337)
            gpu = sess.demix_track(short, ref_opts)
            cpu = make_session("cpu").demix_track(short, ref_opts)
            diff, scale = float(np.abs(gpu - cpu).max()), float(np.abs(cpu).max())
            if not diff < SEP_REF_TOL * max(scale, 1.0):
                raise AssertionError(f"serving {kind}: GPU session vs CPU session max diff "
                                     f"{diff}, scale {scale}")
            out["session"] = dict(demix_track_bit_identical=True,
                                  gpu_vs_cpu=dict(max_abs_diff=diff, scale=scale))

            # the fused default server: /health, /separate, /stream
            srv, host, port = _serve(batch=MAIN_BATCH, **source)
            try:
                import urllib.request

                with urllib.request.urlopen(f"http://{host}:{port}/health", timeout=60) as r:
                    health = json.loads(r.read())
                if health["status"] != "ok" or health["sources"] != list(cfg.sources):
                    raise AssertionError(f"serving {kind}: /health {health}")
                got = _zip_stems(_http_separate(host, port, body), cfg.sources)  # warm
                # the same fused pass, as an exclusive call on the feeder's thread
                ref = srv.feeder.run_exclusive(lambda: srv.session.demix_track(
                    track, srv.separator.options)).result()
                sdiff = float(np.abs(got - ref).max())
                if got.shape != ref.shape or sdiff > budget(track):
                    raise AssertionError(f"serving {kind}: /separate against the session's "
                                         f"fused pass max diff {sdiff}")
                (n_seg, _, _), = srv.separator._fused_cache.keys()
                groups = math.ceil(n_seg / srv.separator._fused_auto_sub())
                zero()
                torch.cuda.synchronize()
                lat = []
                for _ in range(SERVE_TIMED):
                    t0 = time.perf_counter()
                    _http_separate(host, port, body)
                    lat.append(time.perf_counter() - t0)
                want = {k: c * groups * SERVE_TIMED for k, c in per_batch.items()}
                if counts() != want:
                    raise AssertionError(f"serving {kind}: /separate launches {counts()}, want "
                                         f"{want} ({groups} groups of the fused pass)")
                # /stream in 1 s chunks through the feeder's batches
                stats0 = dict(srv.feeder.stats)
                zero()
                t0 = time.perf_counter()
                streamed = _http_stream(host, port, track, chunk)
                stream_s = time.perf_counter() - t0
                calls = srv.feeder.stats["device_calls"] - stats0["device_calls"]
                want = {k: c * calls for k, c in per_batch.items()}
                if counts() != want:
                    raise AssertionError(f"serving {kind}: /stream launches {counts()}, want "
                                         f"{want} ({calls} feeder calls)")
                mono = track.mean(0)
                direct = StreamingSeparator(srv.session.model, cfg.num_sources,
                                            max_batch=MAIN_BATCH)
                offline = np.concatenate(
                    [o for o in [direct.push(track[:, p:p + chunk]) for p in range(0, n, chunk)]
                     + [direct.flush()] if o.shape[-1]], -1)
                tdiff = float(np.abs(streamed - offline).max()) \
                    if streamed.shape == offline.shape else float("inf")
                if tdiff > budget(track):
                    raise AssertionError(f"serving {kind}: /stream against a direct stream "
                                         f"max diff {tdiff} (stats {float(mono.std())})")
            finally:
                _stop_server(srv)
            out["fused_server"] = dict(
                separate_latency_s=lat, separate_median_s=statistics.median(lat),
                separate_realtime=TRACK_SECS / statistics.median(lat), fused_groups=groups,
                against_session_max_abs_diff=sdiff, stream_s=stream_s,
                stream_realtime=TRACK_SECS / stream_s, stream_feeder_calls=calls,
                stream_against_direct_max_abs_diff=tdiff, health=health)
            log(f"serving {kind}: /separate of {TRACK_SECS:g} s, median of {SERVE_TIMED} "
                f"{statistics.median(lat):.3f} s ({TRACK_SECS / statistics.median(lat):.1f}x "
                f"realtime; {groups} fused groups a request); /stream in "
                f"{STREAM_CHUNK_SECS:g} s chunks {stream_s:.3f} s ({calls} feeder calls, "
                f"{TRACK_SECS / stream_s:.2f}x realtime); GPU vs CPU session max|diff| "
                f"{diff:.3e} (scale {scale:.3e}) [{card}]")

            # concurrent uploads to a --no-fused server
            srv, host, port = _serve(batch=MAIN_BATCH, fused=False, **source)
            try:
                stats = srv.feeder.stats
                c0 = stats["device_calls"]
                t0 = time.perf_counter()
                serial = [_zip_stems(_http_separate(host, port, conc_body), cfg.sources)
                          for _ in range(SERVE_CONCURRENT)]
                serial_s = time.perf_counter() - t0
                serial_calls = stats["device_calls"] - c0

                def concurrent():
                    import threading

                    blobs = [None] * SERVE_CONCURRENT

                    def post(i):
                        blobs[i] = _http_separate(host, port, conc_body)

                    threads = [threading.Thread(target=post, args=(i,))
                               for i in range(SERVE_CONCURRENT)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    return blobs

                zero()
                c0, e0 = stats["device_calls"], stats["exclusive_calls"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                blobs = concurrent()
                conc_s = time.perf_counter() - t0
                conc_calls = stats["device_calls"] - c0
                want = {k: c * conc_calls for k, c in per_batch.items()}
                if counts() != want or stats["exclusive_calls"] != e0:
                    raise AssertionError(f"serving {kind}: concurrent launches {counts()}, "
                                         f"want {want} ({conc_calls} feeder calls)")
                if None in blobs or not conc_calls < serial_calls:
                    raise AssertionError(f"serving {kind}: {conc_calls} device calls for "
                                         f"{SERVE_CONCURRENT} concurrent uploads, "
                                         f"{serial_calls} one at a time")
                cdiff = max(float(np.abs(_zip_stems(b, cfg.sources) - s).max())
                            for b, s in zip(blobs, serial))
                if cdiff > budget(conc_track):
                    raise AssertionError(f"serving {kind}: concurrent stems differ from the "
                                         f"serial ones by {cdiff}")
                prof = profile_device(concurrent, f"serving {kind}: {SERVE_CONCURRENT} "
                                                  f"concurrent uploads")
            finally:
                _stop_server(srv)
            out["concurrent"] = dict(
                requests=SERVE_CONCURRENT, track_secs=SERVE_CONCURRENT_SECS,
                serial_wall_s=serial_s, concurrent_wall_s=conc_s, speedup=serial_s / conc_s,
                serial_device_calls=serial_calls, concurrent_device_calls=conc_calls,
                launches=want, against_serial_max_abs_diff=cdiff,
                busy_share=prof.get("busy_share"), profile_wall_ms=prof.get("wall_ms"),
                device_ms=prof.get("device_ms"))
            log(f"serving {kind}: {SERVE_CONCURRENT} uploads of {SERVE_CONCURRENT_SECS:g} s "
                f"to a --no-fused server: serial {serial_s:.3f} s ({serial_calls} device "
                f"calls), concurrent {conc_s:.3f} s ({conc_calls} device calls, "
                f"{serial_s / conc_s:.2f}x); busy share of a concurrent round "
                f"{_pct(prof.get('busy_share'))}; concurrent vs serial stems max|diff| "
                f"{cdiff:.3e} [{card}]")

            # the export: the graph calls the custom ops; the loaded program
            # runs on the card
            if not bag:
                mix = torch.from_numpy(track[None, :, :SEGMENT_SAMPLES].copy()).cuda()
                t0 = time.monotonic()
                blob = sess.export_program(batch_size=1)
                fn = DemixSession.load_exported(blob)
                export_s = time.monotonic() - t0
                ops = sorted({str(nd.target) for nd in fn.graph.nodes
                              if str(nd.target).startswith("demucs_tpu_torch.")})
                want_ops = sorted(f"demucs_tpu_torch.{k}.default"
                                  for k, c in per_batch.items() if c)
                if ops != want_ops:
                    raise AssertionError(f"serving {kind}: the exported program calls {ops}, "
                                         f"want {want_ops}")
                # under torch's default flags (cuDNN's TF32 on): the loaded
                # program scopes TF32 off itself, as the live model does
                flags = dict(cudnn=torch.backends.cudnn.allow_tf32,
                             matmul=torch.backends.cuda.matmul.allow_tf32)
                zero()
                with torch.no_grad():
                    got = fn(mix)
                launched = counts()
                with torch.inference_mode():
                    ref = sess.model(mix).float()
                escale = float(ref.abs().max())
                ediff = float((got - ref).abs().max())
                if launched != per_batch or not ediff <= EXPORT_TOL * escale:
                    raise AssertionError(
                        f"serving {kind}: the exported program launches {launched} (want "
                        f"{per_batch}), against live max diff {ediff} under the flags "
                        f"{flags} (scale {escale}, tolerance {EXPORT_TOL:g} of it)")
                out["export"] = dict(bytes=len(blob), ops=ops, launches=launched,
                                     max_abs_diff=ediff, allow_tf32=flags, scale=escale,
                                     export_and_load_s=export_s)
                log(f"serving {kind}: exported segment program, {len(blob)} bytes in "
                    f"{export_s:.1f} s (export and load), calls "
                    f"{', '.join(o.split('.')[1] for o in ops)}; on the card against live "
                    f"max|diff| {ediff:.3e} under torch's flags allow_tf32 {flags} "
                    f"(scale {escale:.3e}, tolerance {EXPORT_TOL:g} of it)")
            del sess
            torch.cuda.empty_cache()
            out["phase_s"] = time.monotonic() - t_kind
            summary[kind] = out
    return summary


def profile_device(fn, what: str) -> dict:
    """One more warm call of `fn` under torch.profiler: device time by
    layer, the largest kernels, and the device's busy share of the wall
    time (the profiler's own overhead is in that wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from demucs_tpu_torch.utils.profiling import kernel_class

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
        cls = kernel_class(key)
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


def training_launches(kind: str, steps: int, remat: str | None = None) -> dict:
    """The kernel launches of `steps` full-width training steps of `kind`
    (htdemucs_4s or hdemucs_mmi): each forward kernel of `_family`'s
    segment graph once a step (v4's attention as K2, not K1, and K3 once
    for each K2), and with `remat` once more in the backward where its
    policy recomputes it (`train.REMAT_POLICIES`: every policy recomputes
    K4, K5 and K6, whose outputs end in elementwise ops; "dots" keeps K2's
    outputs, "dots_nb" and "none" run K2 again); no other kernel."""
    _, _, per_batch = _family(kind)
    fwd = dict(per_batch)
    attn = fwd.pop("flash_mha")
    fwd["flash_mha_fwd"] = attn
    want = {}
    for name, n in fwd.items():
        again = remat is not None and not (remat == "dots" and name == "flash_mha_fwd")
        want[name] = n * steps * (2 if again else 1)
    want.update(flash_mha=0, flash_mha_bwd=attn * steps)
    return {name: want[name] for name in per_batch}


def _reset_launches() -> None:
    from demucs_tpu_torch.ops.cuda import KERNELS

    for kernel in KERNELS:
        kernel.launches = 0
        if hasattr(kernel, "launches_by_dtype"):
            kernel.launches_by_dtype = dict.fromkeys(kernel.launches_by_dtype, 0)


def _launches() -> tuple[dict, dict]:
    """(launches per kernel, launches per kernel and dtype) since the reset."""
    from demucs_tpu_torch.ops.cuda import KERNELS

    return ({kernel.__name__: kernel.launches for kernel in KERNELS},
            {kernel.__name__: dict(kernel.launches_by_dtype) for kernel in KERNELS
             if hasattr(kernel, "launches_by_dtype")})


def _step_lines(text: str) -> list[tuple[int, float, float]]:
    return [(int(m[1]), float(m[2]), float(m[3])) for m in _STEP_LINE.finditer(text)]


TRAIN_FAMILY = {"htdemucs_4s": "htdemucs_4s", "hdemucs_mmi": "hdemucs_v3"}  # the CLI's --family


def phase_training(card: str, kind: str = "htdemucs_4s"):
    """Training: full-width `kind` (htdemucs_4s or hdemucs_mmi) through the
    port's training CLI on the GPU (synthetic stems, EMA, checkpoints,
    ggml export), then resumed; the exported file separates a short track
    through the inference CLI; one more warm step under the profiler.
    Returns (launch counts, steps, summary)."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE, SEGMENT_SAMPLES
    from demucs_tpu_torch.data import augmented_step, draw_augmentation
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.train import TrainStep

    cfg, schema, _ = _family(kind)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = ["--synthetic", "--family", TRAIN_FAMILY[kind], "--device", "cuda",
                  "--batch", str(TRAIN_BATCH), "--ema", "0.999", "--ckpt", str(tmp / "ckpt"),
                  "--save-every", "2", "--log-every", "1", "--seed", "0"]
        _reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log1 = _train_cli(common + ["--steps", str(TRAIN_STEPS),
                                    "--export-ggml", str(tmp / "trained.bin")])
        torch.cuda.synchronize()
        first = _launches()[0]
        peak_mem = torch.cuda.max_memory_allocated()
        log2 = _train_cli(common + ["--steps", str(RESUME_STEPS), "--resume"])
        torch.cuda.synchronize()
        launches = _launches()[0]

        for n_steps, counts in ((TRAIN_STEPS, first), (RESUME_STEPS, launches)):
            want = training_launches(kind, n_steps)
            if counts != want:
                raise AssertionError(f"{kind} training launches {counts} after {n_steps} "
                                     f"steps, want {want}")
        if f"resumed at step {TRAIN_STEPS}" not in log2:
            raise AssertionError(f"the resumed run did not start at step {TRAIN_STEPS}")
        steps = [_step_lines(text) for text in (log1, log2)]
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
    model = build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda",
                        train=True)
    step = TrainStep(model, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stems = 0.05 * torch.randn(TRAIN_BATCH, cfg.num_sources, 2, SEGMENT_SAMPLES,
                               device="cuda", generator=gen)

    def one_step():
        augmented_step(step, stems, draw_augmentation(stems.shape, gen))

    one_step()
    torch.cuda.synchronize()
    profile = profile_device(one_step, f"one warm {kind} training step (batch {TRAIN_BATCH})")
    split = None
    if kind == "hdemucs_mmi":
        split = v3_step_split(step, stems, gen)
    del step, model, stems
    torch.cuda.empty_cache()

    summary = dict(batch=TRAIN_BATCH, segment_samples=SEGMENT_SAMPLES,
                   steps=RESUME_STEPS, losses=losses, median_warm_step_s=step_s,
                   audio_s_trained_per_s=audio_s, max_memory_allocated=peak_mem,
                   launches=launches, profile=profile, card=card)
    if split is not None:
        summary["step_split"] = split
    log(f"training: {kind}, batch {TRAIN_BATCH} x {SEGMENT_SAMPLES} samples, "
        f"{TRAIN_STEPS} steps then resumed to {RESUME_STEPS}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; median warm step {step_s:.4f} s, "
        f"{audio_s:.3f} audio-s trained/s, max_memory_allocated {peak_mem} B, "
        f"launches {launches} [{card}]")
    return launches, RESUME_STEPS, summary


def v3_step_split(step, stems, gen) -> dict:
    """Where a warm v3 training step's time goes between K6's forward and
    the plain twin's recomputing backward: the step's wall (host clock,
    synchronized), and CUDA events around every K6 launch of the forward
    and around every recomputing backward of `ops.BiLSTMRecurrence` in the
    backward, and around K4's (`ops.GnGluScaleRes`) forward and backward
    (the Functions wrapped for this one step), summed."""
    import torch

    from demucs_tpu_torch.data import augmented_step, draw_augmentation
    from demucs_tpu_torch.ops import GnGluScaleRes
    from demucs_tpu_torch.ops import lstm as port_lstm

    spans = {"k6_forward": [], "twin_backward": [], "k4_forward": [], "k4_twin_backward": []}

    def timed(kind, inner):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args)
            end.record()
            spans[kind].append((start, end))
            return out
        return run

    wrapped = ((port_lstm.BiLSTMRecurrence, "k6_forward", "twin_backward"),
               (GnGluScaleRes, "k4_forward", "k4_twin_backward"))
    saved = [(fn, fn.forward, fn.backward) for fn, _, _ in wrapped]
    for fn, f, b in wrapped:
        fn.forward = staticmethod(timed(f, fn.forward))
        fn.backward = staticmethod(timed(b, fn.backward))
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        augmented_step(step, stems, draw_augmentation(stems.shape, gen))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    finally:
        for fn, fwd, bwd in saved:
            fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
    out = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    out.update(step_ms=wall_ms, calls={k: len(v) for k, v in spans.items()})
    log(f"v3 training step split: wall {wall_ms:.1f} ms; K6 forward {out['k6_forward']:.1f} ms "
        f"over {len(spans['k6_forward'])} calls; the twin's recomputing backward "
        f"{out['twin_backward']:.1f} ms over {len(spans['twin_backward'])} calls "
        f"({out['twin_backward'] / wall_ms:.1%} of the step); K4 forward "
        f"{out['k4_forward']:.2f} ms, its twin's backward {out['k4_twin_backward']:.2f} ms "
        f"over {len(spans['k4_twin_backward'])} calls")
    return out


def phase_training_modes(card: str) -> dict:
    """The training CLI's modes at full width, a few steps each, batch
    TRAIN_BATCH: htdemucs-4s without remat and with --remat none, dots and
    dots_nb (peak memory against no remat; --remat none must lower it;
    launches per `training_launches`), htdemucs-4s and hdemucs_mmi with
    --bf16-compute (every launch in its bf16 form), htdemucs-4s with both
    (the recompute on the bf16 weights), hdemucs_mmi with --remat none,
    --steps-per-call 2
    (log lines at multiples of 2), and --eval-every 2 with --eval-sdr on
    the synthetic held-out track (K1 and K5 of the evaluation's
    separation beside the training's launches; finite L1 and SDRs, the
    .eval.jsonl records, the .best checkpoint)."""
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE, SEGMENT_SAMPLES

    runs = {
        "htdemucs_4s": ("htdemucs_4s", [], None, 2),
        "htdemucs_4s --remat none": ("htdemucs_4s", ["--remat", "--remat-policy", "none"],
                                     "none", 2),
        "htdemucs_4s --remat dots": ("htdemucs_4s", ["--remat"], "dots", 2),
        "htdemucs_4s --remat dots_nb": ("htdemucs_4s", ["--remat", "--remat-policy",
                                                        "dots_nb"], "dots_nb", 2),
        "htdemucs_4s --bf16-compute": ("htdemucs_4s", ["--bf16-compute"], None, 2),
        "hdemucs_mmi --bf16-compute": ("hdemucs_mmi", ["--bf16-compute"], None, 2),
        "htdemucs_4s --remat none --bf16-compute": (
            "htdemucs_4s", ["--remat", "--remat-policy", "none", "--bf16-compute"], "none", 2),
        "hdemucs_mmi --remat none": ("hdemucs_mmi", ["--remat", "--remat-policy", "none"],
                                     "none", 2),
        "htdemucs_4s --steps-per-call 2": ("htdemucs_4s", ["--steps-per-call", "2"], None, 4),
        "htdemucs_4s --eval-every 2 --eval-sdr": ("htdemucs_4s", [
            "--eval-every", "2", "--eval-sdr", "--ema", "0.999"], None, 2),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (kind, flags, remat, n_steps) in runs.items():
            ckpt = Path(tmp) / label.replace(" ", "_")
            _reset_launches()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            text = _train_cli(["--synthetic", "--family", TRAIN_FAMILY[kind], "--device",
                               "cuda", "--batch", str(TRAIN_BATCH), "--log-every", "1",
                               "--steps", str(n_steps), "--save-every", "100",
                               "--ckpt", str(ckpt), *flags])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches, by_dtype = _launches()
            want = training_launches(kind, n_steps, remat)
            rec = dict(launches=launches, max_memory_allocated=peak)
            if "--eval-every" in flags:
                # the evaluation's separations: K1 10 and K5 32 per segment batch
                batches = launches["flash_mha"] / 10
                if not batches or batches != int(batches):
                    raise AssertionError(f"{label}: K1 {launches['flash_mha']} launches")
                want.update(flash_mha=launches["flash_mha"],
                            dconv_sub_block=want["dconv_sub_block"] + 32 * int(batches))
                recs = [json.loads(line) for line in open(str(ckpt) + ".eval.jsonl")]
                if [r["step"] for r in recs] != [2] or not math.isfinite(recs[0]["l1"]) \
                        or not all(math.isfinite(v) for v in recs[0]["sdr"].values()):
                    raise AssertionError(f"{label}: eval records {recs}")
                if not Path(str(ckpt) + ".best").exists():
                    raise AssertionError(f"{label}: no .best checkpoint")
                rec.update(eval=recs, eval_segment_batches=int(batches))
            if launches != want:
                raise AssertionError(f"{label}: launches {launches}, want {want}")
            if "--bf16-compute" in flags and any(
                    counts["float32"] for counts in by_dtype.values()):
                raise AssertionError(f"{label}: an f32 launch under bf16 compute: {by_dtype}")
            lines = _step_lines(text)
            K = 2 if "--steps-per-call" in flags else 1
            if [s for s, _, _ in lines] != list(range(K, n_steps + 1, K)) or not all(
                    math.isfinite(loss) for _, loss, _ in lines):
                raise AssertionError(f"{label}: logged steps {lines}")
            rec["step_s"] = lines[-1][2]  # the warm call(s) after the first
            rec["audio_s_trained_per_s"] = TRAIN_BATCH * SEGMENT_SAMPLES / SAMPLE_RATE \
                / rec["step_s"]
            rec["launches_by_dtype"] = by_dtype
            out[label] = rec
            log(f"training mode {label}: {n_steps} steps, last logged step_s "
                f"{rec['step_s']:.4f} s ({rec['audio_s_trained_per_s']:.2f} audio-s trained/s), "
                f"max_memory_allocated {peak} B, launches {launches}"
                + (f", by dtype {by_dtype}" if "--bf16-compute" in flags else "")
                + (f", eval {rec['eval']}" if "eval" in rec else "") + f" [{card}]")
    base = out["htdemucs_4s"]["max_memory_allocated"]
    if not out["htdemucs_4s --remat none"]["max_memory_allocated"] < base:
        raise AssertionError(f"--remat none does not lower the peak memory: "
                             f"{out['htdemucs_4s --remat none']['max_memory_allocated']} "
                             f"against {base} without remat")
    log("training modes: peak memory against no remat: " + ", ".join(
        f"{label} {rec['max_memory_allocated'] / base:.3f}" for label, rec in out.items()
        if label.startswith("htdemucs_4s --remat") and "bf16" not in label))
    return out


def phase_reference(kind: str, quant: str | None = None):
    """The same `kind` model, with int8 weights if `quant` is "int8", on
    the GPU (CUDA kernels) and the CPU (plain twins) must agree on a short
    segment; returns the mix and the CPU's estimate."""
    import numpy as np
    import torch

    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import from_state_dict, init_flat, quantize_int8

    cfg, schema, _ = _family(kind, quant)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    if quant == "int8":
        sd = quantize_int8(sd)
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, sd, device)
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    scale = float(np.abs(outs["cpu"]).max())
    label = kind + (f" --{quant}" if quant else "")
    if not (np.isfinite(outs["cuda"]).all() and diff < SEP_REF_TOL * max(scale, 1.0)):
        raise AssertionError(f"GPU vs CPU {label}: max diff {diff}, scale {scale}")
    log(f"reference: {label} (1, 2, 32768) GPU vs CPU max|diff| {diff:.3e} "
        f"(scale {scale:.3e}, tolerance {SEP_REF_TOL:g} * max(scale, 1))")
    return mix, outs["cpu"], dict(max_abs_diff=diff, scale=scale)


# bf16 compute, GPU against CPU: the median over the tensors of
# |g_gpu - g_cpu| / |g_cpu_f32| within twice the CPU's own bf16 error, that
# median of |g_cpu_bf16 - g_cpu_f32| / |g_cpu_f32| (the rule the CPU tests
# hold the port's bf16 gradients to the JAX package's by); the loss to 1e-3
TRAIN_REF_BF16_LOSS_TOL = 1e-3
# LocalState's key biases add q.b to every logit of a query, which the
# softmax over the keys removes: their gradient is a rounding residue on
# both devices, held to 1e-5 of the largest gradient entry
TRAIN_REF_ZERO_TOL = 1e-5


def _reference_step(kind: str, sd: dict, mix, refs, device: str, compute_dtype=None):
    """One training step's loss and gradients (f64, on the CPU) of `kind`
    from `sd` on `device`."""
    import torch

    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.train import TrainStep

    cfg, _, _ = _family(kind)
    step = TrainStep(build_model(cfg, sd, device, train=True), compute_dtype=compute_dtype)
    loss = step(torch.from_numpy(mix).to(device), torch.from_numpy(refs).to(device))
    grads = {n: p.grad.detach().cpu().double() for n, p in step.model.named_parameters()}
    return loss.item(), grads


def _median_rel(grads, ref, norm_of) -> float:
    rels = [(grads[n] - ref[n]).norm().item() / f.norm().item()
            for n, f in norm_of.items() if f.norm().item() > 1e-6]
    return statistics.median(rels)


def phase_reference_training(kind: str, mix, est):
    """One training step of the full-width `kind` on a short segment on the
    GPU (v4: K2, K3, K5; v3: K6, K5, K4 through their Functions) and on
    the CPU (plain twins), from the same weights and data: the losses and
    every parameter's gradient agree; then the same step with bf16
    compute on both devices (the rule above TRAIN_REF_BF16_LOSS_TOL).

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

    from demucs_tpu_torch.models import feeds_group_norm
    from demucs_tpu_torch.params import from_state_dict, init_flat

    _, schema, _ = _family(kind)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    rng = np.random.default_rng(7)
    sign = np.sign(rng.standard_normal(est.shape))
    refs = (est + sign * (0.1 + 0.4 * rng.random(est.shape))).astype(np.float32)
    (loss_g, grads_g), (loss_c, grads_c) = (_reference_step(kind, sd, mix, refs, device)
                                            for device in ("cuda", "cpu"))
    if not abs(loss_g - loss_c) <= TRAIN_REF_LOSS_TOL * abs(loss_c):
        raise AssertionError(f"{kind} training loss GPU {loss_g} vs CPU {loss_c}")
    top = max(g.abs().max().item() for g in grads_c.values())
    rels, residue = [], 0.0
    for name, gc in grads_c.items():
        gg = grads_g[name]
        if not torch.isfinite(gg).all():
            raise AssertionError(f"non-finite GPU gradient {name}")
        if name.endswith("4.key.bias") and kind == "hdemucs_mmi":
            if max(gg.abs().max().item(), gc.abs().max().item()) > TRAIN_REF_ZERO_TOL * top:
                raise AssertionError(f"{name}: a key bias gradient beyond rounding")
            continue
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
        raise AssertionError(f"{kind} GPU vs CPU gradient of {worst_name}: |diff|/|cpu| {worst}")
    if not residue <= TRAIN_REF_GRAD_TOL * top:
        raise AssertionError(f"GroupNorm-removed bias gradient means differ by {residue}, "
                             f"largest gradient entry {top}")
    kernels = "K2, K3, K5" if kind.startswith("htdemucs") else "K6, K5, K4"
    log(f"reference: one training step of {kind} {mix.shape}, GPU ({kernels}) vs CPU "
        f"(plain twins): loss {loss_g:.8f} vs {loss_c:.8f} (rel {abs(loss_g - loss_c) / loss_c:.2e}, "
        f"tolerance {TRAIN_REF_LOSS_TOL:g}); worst gradient |diff|/|cpu| {worst:.2e} "
        f"({worst_name}; tolerance {TRAIN_REF_GRAD_TOL:g}, {len(grads_c)} tensors; "
        f"the GroupNorm-removed means of the DConv bias gradients, zero up to rounding, "
        f"differ by at most {residue:.2e}, {residue / top:.1e} of the largest entry)")
    out = dict(loss_rel_err=abs(loss_g - loss_c) / loss_c, worst_grad_rel_err=worst,
               worst_grad=worst_name)

    (bloss_g, bgrads_g), (bloss_c, bgrads_c) = (
        _reference_step(kind, sd, mix, refs, device, torch.bfloat16) for device in ("cuda", "cpu"))
    if not all(torch.isfinite(g).all() for g in bgrads_g.values()):
        raise AssertionError(f"{kind} bf16 compute: a non-finite GPU gradient")
    gpu_cpu = _median_rel(bgrads_g, bgrads_c, grads_c)
    cpu_err = _median_rel(bgrads_c, grads_c, grads_c)
    out["bf16"] = dict(loss_gpu=bloss_g, loss_cpu=bloss_c, loss_f32=loss_c,
                       median_rel_gpu_vs_cpu=gpu_cpu, median_rel_cpu_bf16_vs_f32=cpu_err,
                       median_rel_gpu_bf16_vs_f32=_median_rel(bgrads_g, grads_c, grads_c))
    if not (abs(bloss_g - bloss_c) <= TRAIN_REF_BF16_LOSS_TOL * loss_c
            and gpu_cpu <= 2 * cpu_err):
        raise AssertionError(f"{kind} bf16 compute GPU vs CPU: {out['bf16']}")
    log(f"reference: one bf16-compute training step of {kind}, GPU vs CPU: {out['bf16']} "
        f"(rule: |loss diff| <= {TRAIN_REF_BF16_LOSS_TOL:g} loss, median over tensors of "
        f"|g_gpu - g_cpu| / |g_cpu_f32| <= 2 x that of |g_cpu_bf16 - g_cpu_f32|)")
    return out


def _resumed_step_is_exact(kind: str, gen) -> str:
    """One full-width training step of `kind`, saved, loaded into a fresh
    model and optimizer, one more step: equal to 2 uninterrupted steps bit
    for bit (every parameter and the EMA, torch.equal)."""
    import torch

    from demucs_tpu_torch.config import SEGMENT_SAMPLES
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.train import TrainStep, load_train_state, save_train_state

    cfg, schema, _ = _family(kind)
    sd = from_state_dict(init_flat(schema, seed=0), schema)
    batches = []
    for _ in range(2):
        stems = 0.05 * torch.randn(TRAIN_BATCH, cfg.num_sources, 2, SEGMENT_SAMPLES,
                                   device="cuda", generator=gen)
        batches.append((stems.sum(1), stems))

    def fresh():
        return TrainStep(build_model(cfg, sd, "cuda", train=True), ema_decay=0.999)

    ref = fresh()
    for mix, refs in batches:
        ref(mix, refs)
    want = ({n: p.detach().clone() for n, p in ref.model.named_parameters()},
            {n: e.clone() for n, e in ref.ema.items()})
    del ref
    with tempfile.TemporaryDirectory() as tmp:
        first = fresh()
        first(*batches[0])
        save_train_state(Path(tmp) / "ckpt", first)
        del first
        resumed = fresh()
        if load_train_state(Path(tmp) / "ckpt", resumed) != 1:
            raise AssertionError("the checkpoint did not restore step 1")
        resumed(*batches[1])
    got = (dict(resumed.model.named_parameters()), resumed.ema)
    for what, a, b in (("parameter", want[0], got[0]), ("EMA", want[1], got[1])):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"resumed {kind} training step: {what} {name} differs "
                                     f"from the uninterrupted run's")
    del resumed, batches
    torch.cuda.empty_cache()
    return (f"a resumed training step of {kind} (batch {TRAIN_BATCH} x {SEGMENT_SAMPLES}): "
            f"{len(want[0])} parameters and the EMA")


def phase_determinism(card: str):
    """Bit-reproducibility on the card: K1 (the four attention shapes), K2
    (out, lse), K3 (dq, dk, dv), K6, K5 (a frequency row over a cluster, a
    time row in tiles), K7 (three linear shapes) and K4 (both tails) called
    twice on one input at the paths' shapes (and K2, K3 at a ragged one),
    K1, K4, K5 and K6 in f32 and in bf16, must agree bit for bit, and one
    resumed training step of the full-width htdemucs-4s and of
    hdemucs_mmi must equal the uninterrupted run's
    (`_resumed_step_is_exact`)."""
    import torch

    from demucs_tpu_torch.ops.cuda import (bilstm_recurrence, dconv_sub_block, flash_mha,
                                           flash_mha_bwd, flash_mha_fwd, gn_glu_scale_res,
                                           int8_matmul)
    from demucs_tpu_torch.ops.cuda.dconv import card_capacity, dconv_plan
    from demucs_tpu_torch.ops.cuda.quant_matmul import quant_plan

    gen = torch.Generator(device="cuda").manual_seed(5)
    checked = []
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    with torch.inference_mode():
        for (T, S), (tag, dtype) in itertools.product(ATTN_SHAPES, dtypes.items()):
            q, k, v = (torch.randn(MAIN_BATCH, HEADS, n, 64, device="cuda",
                                   generator=gen).to(dtype) for n in (T, S, S))
            if not torch.equal(flash_mha(q, k, v), flash_mha(q, k, v)):
                raise AssertionError(f"K1 differs between two calls at T={T} S={S} {tag}")
            checked.append(f"K1 ({MAIN_BATCH},{HEADS},{T},{S},64) {tag}")
        for B, H, T, S, D, dtype in ((TRAIN_BATCH, HEADS, 2688, 2688, 64, torch.float32),
                                     (TRAIN_BATCH, HEADS, 2688, 2688, 64, torch.bfloat16),
                                     (2, 3, 130, 257, 48, torch.float32)):
            q, k, v, do = (torch.randn(B, H, n, D, device="cuda", generator=gen).to(dtype)
                           for n in (T, S, S, T))
            o, lse = flash_mha_fwd(q, k, v)
            o2, lse2 = flash_mha_fwd(q, k, v)
            for name, a, b in (("out", o, o2), ("lse", lse, lse2)):
                if not torch.equal(a, b):
                    raise AssertionError(f"K2's {name} differs between two calls at "
                                         f"({B},{H},{T},{S},{D}) {dtype}")
            first, second = flash_mha_bwd(q, k, v, o, lse, do), flash_mha_bwd(q, k, v, o, lse, do)
            for name, a, b in zip(("dq", "dk", "dv"), first, second):
                if not torch.equal(a, b):
                    raise AssertionError(f"K3's {name} differs between two calls at "
                                         f"({B},{H},{T},{S},{D}) {dtype}")
            checked.append(f"K2 and K3 ({B},{H},{T},{S},{D}) {str(dtype).split('.')[-1]}")
        for (T, H), (tag, dtype) in itertools.product(LSTM_SHAPES, dtypes.items()):
            xs = torch.randn(T, 2, MAIN_BATCH, 4 * H, device="cuda", generator=gen).to(dtype)
            w_hh = (torch.randn(2, H, 4 * H, device="cuda", generator=gen) / H ** 0.5).to(dtype)
            if not torch.equal(bilstm_recurrence(xs, w_hh), bilstm_recurrence(xs, w_hh)):
                raise AssertionError(f"K6 differs between two calls at T={T} H={H} {tag}")
            checked.append(f"K6 ({T},2,{MAIN_BATCH},{4 * H}) {tag}")
        # K5 on htdemucs-4s's freq3 and time0 rows at the path's batch
        for (N, C, T, dil), (tag, dtype) in itertools.product(
                ((MAIN_BATCH * DCONV_FREQ_ROWS[3], 384, DCONV_FREQ_T, 2),
                 (MAIN_BATCH, 48, DCONV_TIME_T[0], 1)), dtypes.items()):
            h = C // DCONV_COMP["htdemucs_4s"]
            x = torch.randn(N, C, T, device="cuda", generator=gen).to(dtype)
            ws = [(torch.randn(*shape, device="cuda", generator=gen) * 0.3).to(dtype)
                  for shape in ((h, C, 3), (h,), (h,), (h,), (2 * C, h, 1), (2 * C,), (2 * C,),
                                (2 * C,), (C,))]
            if not torch.equal(dconv_sub_block(x, *ws, dil), dconv_sub_block(x, *ws, dil)):
                raise AssertionError(f"K5 differs between two calls at x ({N},{C},{T}), h={h} "
                                     f"{tag}")
            form = dconv_plan(N, C, h, T, dil, capacity=card_capacity).form
            checked.append(f"K5 ({N},{C},{T}) h={h} {form} {tag}")
        # K7 at a v4 linear2, linear1 and v3 shape of the path's batch, K4 at both tails
        for M, K, N in ((MAIN_BATCH * 2688, 2048, 512), (MAIN_BATCH * 1344, 512, 2048),
                        (MAIN_BATCH * 336, 384, 192)):
            x, q, scale, b = _int8_operands(gen, M, N, K)
            s = scale.reshape(-1)
            if not torch.equal(int8_matmul(x, q, s, b), int8_matmul(x, q, s, b)):
                raise AssertionError(f"K7 differs between two calls at M={M} K={K} N={N}")
            plan = quant_plan(M, N, K, x.data_ptr(), q.data_ptr())
            checked.append(f"K7 ({M},{K}) x ({N},{K}) {plan.form} {plan.rows}x{plan.cols}")
        for (C, T), (tag, dtype) in itertools.product(TAIL_SHAPES, dtypes.items()):
            args = [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
                    for shape in ((MAIN_BATCH, 2 * C, T), (2 * C,), (2 * C,), (C,),
                                  (MAIN_BATCH, C, T))]
            if not torch.equal(gn_glu_scale_res(*args), gn_glu_scale_res(*args)):
                raise AssertionError(f"K4 differs between two calls at C={C} T={T} {tag}")
            checked.append(f"K4 ({MAIN_BATCH},{2 * C},{T}) {tag}")

    for kind in ("htdemucs_4s", "hdemucs_mmi"):
        checked.append(_resumed_step_is_exact(kind, gen))
    log(f"determinism: bit-identical on repeat: {'; '.join(checked)} [{card}]")
    return checked


def _module_outputs(model, x) -> list:
    """(name, outputs) of every module of `model` in the order the modules
    return, for one call on `x`: the tensors of each output, as they are."""
    import torch

    seen, hooks = [], []
    for name, module in model.named_modules():
        def hook(_m, _inp, out, _name=name or "model"):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            seen.append((_name, [o.clone() for o in outs if isinstance(o, torch.Tensor)]))
        hooks.append(module.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_bf16_repeat(card: str) -> dict:
    """Whether a --bf16 network gives the same bits twice on the card, and
    where it first does not: htdemucs-4s and hdemucs_mmi built as --bf16
    builds them, one segment (the stream's batch), run twice with every
    module's output kept; the first module (in the order modules return)
    whose output differs, and the largest difference of the network's
    output against its scale, and one call's time (CUDA events, 5 warm
    calls); then the same under `deterministic_cudnn()` (cuDNN's
    deterministic algorithms only). f32 is held bit for bit by the bag
    phases."""
    import torch

    from demucs_tpu_torch.config import SEGMENT_SAMPLES
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.params import cast_state_dict, from_state_dict, init_flat
    from demucs_tpu_torch.utils.device import deterministic_cudnn

    gen = torch.Generator(device="cuda").manual_seed(9)
    result = {}
    for kind in ("htdemucs_4s", "hdemucs_mmi"):
        cfg, schema, _ = _family(kind)
        sd = cast_state_dict(from_state_dict(init_flat(schema, seed=0), schema), torch.bfloat16)
        model = build_model(cfg, sd, "cuda", quant_dtype=torch.bfloat16)
        x = torch.randn(1, 2, SEGMENT_SAMPLES, device="cuda", generator=gen)
        row = {}
        for flags, scope in (("default", contextlib.nullcontext),
                             ("deterministic_cudnn", deterministic_cudnn)):
            with scope():
                first, second = _module_outputs(model, x), _module_outputs(model, x)
            differ = [name for (name, a), (_, b) in zip(first, second)
                      if len(a) != len(b) or not all(torch.equal(u, v) for u, v in zip(a, b))]
            out_a, out_b = first[-1][1][0].float(), second[-1][1][0].float()
            scale, n_modules = out_a.abs().max().item(), len(first)
            del first, second
            with scope(), torch.inference_mode():
                ms = time_ms(lambda: model(x), 5)
            row[flags] = dict(bit_identical=not differ, modules=n_modules,
                              modules_differing=len(differ), first_differing=differ[:3],
                              max_abs_diff=(out_a - out_b).abs().max().item(), scale=scale,
                              ms=ms)
        result[kind] = row
        log(f"bf16 repeat {kind} (1, 2, {SEGMENT_SAMPLES}), twice: {row} [{card}]")
        del model, sd
        torch.cuda.empty_cache()
    return result


# --- slice 16: the native helpers, the measuring tools, INT8_SKIPS -------------------

NATIVE_TURNS = 3         # timed calls per reader, in turns
# INT8_SKIPS on against off: the JAX test's gate (tests/test_quant.py, the fp8
# relative bound: dSDR <= 0.05 dB at a nominal 10 dB separation SDR)
INT8_SKIPS_GATE = 0.035
LOAD_TRACK_SECS = (TRACK_SECS, LONG_TRACK_SECS)


def _turns(fns: dict, rounds: int = NATIVE_TURNS) -> dict:
    """Host functions timed in turns: {name: (median s, readings)}."""
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            readings[name].append(time.perf_counter() - t0)
    return {name: (statistics.median(r), r) for name, r in readings.items()}


def phase_native(card: str) -> dict:
    """The native helpers (demucs_tpu_torch/native/) on the card's host:
    both libraries build with g++ and load, and no caller falls back to
    numpy (`native.FALLBACK`); load_ggml native against numpy on the
    full-width htdemucs-4s and hdemucs_mmi files and read_wav native
    against numpy on the 20 s and 45 s tracks (f32 WAVs, as the CLI
    writes stems; and PCM16), bit for bit and timed in turns (medians of
    NATIVE_TURNS, warm page cache); then the CLI on the 20 s and 45 s tracks
    (htdemucs-4s, in-process: CUDA and the kernels warm, the model's file
    and the WAV read cold by the CLI), with the time it spends in
    load_ggml (the parse), load_model_params (parse, schema and tensors)
    and read_wav, each as a share of its wall."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli, native
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.params import ggml, init_flat, write_ggml

    libs = {name: native.build_and_load(name) for name in ("ggml_loader", "wav_io")}
    out: dict = {"libraries": {n: str(native.library_path(n)) for n in libs}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for kind in ("htdemucs_4s", "hdemucs_mmi"):
            _, schema, _ = _family(kind)
            path = tmp / f"{kind}.bin"
            write_ggml(path, kind, init_flat(schema, seed=0))
            data = path.read_bytes()
            (kn, tn), (kp, tp) = ggml.load_ggml(data), ggml._load_ggml_numpy(data)
            if kn != kp or list(tn) != list(tp) or any(
                    tn[k].tobytes() != tp[k].tobytes() for k in tp):
                raise AssertionError(f"native load_ggml differs from numpy on {kind}")
            t = _turns({"native": lambda: ggml.load_ggml(data),
                        "numpy": lambda: ggml._load_ggml_numpy(data)})
            out[f"load_ggml {kind}"] = dict(bytes=len(data), tensors=len(tp),
                                            native_s=t["native"][0], numpy_s=t["numpy"][0],
                                            readings=t)
            log(f"native: load_ggml of {kind} ({len(data)} bytes, {len(tp)} tensors): native "
                f"{t['native'][0] * 1e3:.2f} ms, numpy {t['numpy'][0] * 1e3:.2f} ms (medians "
                f"of {NATIVE_TURNS} in turns; bit for bit) [{card}]")
            path.unlink()
        for secs in LOAD_TRACK_SECS:
            x = synthetic_track(int(secs * SAMPLE_RATE))
            for pcm16 in (False, True):
                wav = tmp / f"{secs:g}{'_pcm16' if pcm16 else ''}.wav"
                audio.write_wav(wav, x, pcm16=pcm16)
                a, b = audio.read_wav(wav), audio.read_wav(wav, native=False)
                if a[1] != b[1] or a[0].tobytes() != b[0].tobytes():
                    raise AssertionError(f"native read_wav differs from numpy on {wav.name}")
                t = _turns({"native": lambda: audio.read_wav(wav),
                            "numpy": lambda: audio.read_wav(wav, native=False)})
                label = f"read_wav {secs:g} s {'pcm16' if pcm16 else 'f32'}"
                out[label] = dict(native_s=t["native"][0], numpy_s=t["numpy"][0], readings=t)
                log(f"native: {label}: native {t['native'][0] * 1e3:.2f} ms, numpy "
                    f"{t['numpy'][0] * 1e3:.2f} ms (medians of {NATIVE_TURNS} in turns; bit "
                    f"for bit) [{card}]")

        # the cold CLI: the time inside the loaders, by wrappers around them
        _, schema, _ = _family("htdemucs_4s")
        model_path = tmp / "htdemucs_4s.bin"
        write_ggml(model_path, "htdemucs_4s", init_flat(schema, seed=0))
        spent: dict[str, float] = {}

        def timed(module, name):
            fn = getattr(module, name)

            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return fn, wrapper

        patches = [(ggml, "load_ggml"), (cli, "load_model_params"), (audio, "read_wav")]
        for secs in LOAD_TRACK_SECS:
            spent.clear()
            saved = []
            try:
                for module, name in patches:
                    fn, wrapper = timed(module, name)
                    saved.append((module, name, fn))
                    setattr(module, name, wrapper)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                rc = cli.main([str(model_path), str(tmp / f"{secs:g}.wav"), str(tmp / "stems"),
                               "--device", "cuda", "--batch", str(MAIN_BATCH)])
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            finally:
                for module, name, fn in saved:
                    setattr(module, name, fn)
            if rc != 0:
                raise RuntimeError(f"cli.main exited {rc}")
            share = {k: v / wall for k, v in spent.items()}
            out[f"cold CLI {secs:g} s"] = dict(wall_s=wall, spent_s=dict(spent), share=share)
            log(f"native: the CLI on the {secs:g} s track (htdemucs-4s, in-process, kernels "
                f"built): wall {wall:.3f} s; load_ggml {spent['load_ggml'] * 1e3:.1f} ms "
                f"({share['load_ggml']:.2%}), load_model_params "
                f"{spent['load_model_params'] * 1e3:.1f} ms ({share['load_model_params']:.2%}), "
                f"read_wav {spent['read_wav'] * 1e3:.1f} ms ({share['read_wav']:.2%}) [{card}]")
    if native.FALLBACK:
        raise AssertionError("a native helper fell back to numpy on the card's host")
    out["fallback"] = native.FALLBACK
    return out


def _tool_json(main, argv: list[str]) -> list:
    """Run a tool's main(argv) in-process; the JSON objects of its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"{main.__module__} {argv} exited {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def phase_tools(card: str) -> dict:
    """Each measuring tool once on the card at small counts, its JSON
    checked for sanity and the kernels' launches counted (they must be
    the per-call counts of `_family` times the calls the tool makes):
      * memory_report: htdemucs-4s at batch 1 of the full segment in f32,
        with int8 weights (fewer weight bytes, the same output bytes) and
        one training step with remat (K2, K3); every byte count positive;
      * profile_hlo: htdemucs-4s (K1, K5), --v3 --int8 (K6, K5, K4, K7)
        and --train (K2, K3, K5) at --steps 1, batch MAIN_BATCH: device
        time per step positive, the kernels' classes among its buckets;
      * bench_bag --iters 1 --batch MAIN_BATCH: both strategies;
      * bench_sweep --batches 1 --iters 2 in f32, dense and --quant int8,
        and --family --batches 1 --iters 2: every step time positive."""
    import torch

    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.tools import bench_bag, bench_sweep, memory_report, profile_hlo

    def zero():
        for kernel in KERNELS:
            kernel.launches = 0

    def counts():
        return {kernel.__name__: kernel.launches for kernel in KERNELS}

    def expect(what, want: dict):
        got = counts()
        want = {k.__name__: want.get(k.__name__, 0) for k in KERNELS}
        if got != want:
            raise AssertionError(f"tools: {what} launched {got}, want {want}")
        return got

    _, _, v4 = _family("htdemucs_4s")
    _, _, v4q = _family("htdemucs_4s", "int8")
    _, _, v3q = _family("hdemucs_mmi", "int8")
    per_step = {"flash_mha_fwd": 10, "flash_mha_bwd": 10, "dconv_sub_block": 32}
    times = lambda d, n: {k: n * v for k, v in d.items()}  # noqa: E731
    out: dict = {}
    launches = dict.fromkeys((k.__name__ for k in KERNELS), 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    # memory_report: two calls per report (an untimed one, then the measured one)
    reps = {}
    for label, kw in (("f32", dict(dtype=torch.float32)),
                      ("int8", dict(dtype=torch.float32, int8=True))):
        zero()
        reps[label] = memory_report.compiled_memory("4s", batch=1, **kw)
        add(expect(f"memory_report {label}", times(v4q if "int8" in kw else v4, 2)))
    zero()
    reps["train"] = memory_report.train_compiled_memory("4s", batch=1, remat=True)
    # remat (dots) recomputes each K5 sub-block in the backward: 64 K5 a step
    add(expect("memory_report --train", times(dict(per_step, dconv_sub_block=64), 2)))
    for label, rep in reps.items():
        if not all(rep[k] > 0 for k in ("weight_bytes", "argument_bytes", "output_bytes",
                                        "temp_bytes", "peak_bytes")):
            raise AssertionError(f"memory_report {label}: {rep}")
    if not (reps["int8"]["weight_bytes"] < 0.3 * reps["f32"]["weight_bytes"]
            and reps["int8"]["output_bytes"] == reps["f32"]["output_bytes"]):
        raise AssertionError(f"memory_report: int8 {reps['int8']} against f32 {reps['f32']}")
    out["memory_report"] = reps
    log("tools: memory_report (htdemucs-4s, batch 1): " + "; ".join(
        f"{k}: weights {r['weight_bytes'] / 2**20:.1f} MiB, activations "
        f"{r['temp_bytes'] / 2**20:.1f} MiB, peak {r['peak_bytes'] / 2**20:.1f} MiB"
        for k, r in reps.items()) + f" [{card}]")

    # profile_hlo: 1 untimed + --steps timed + --steps profiled calls
    profiles = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv, want, classes in (
                ("htdemucs-4s", [], v4, ("attention (K1)", "dconv (K5)")),
                ("--v3 --int8", ["--v3", "--int8"], v3q,
                 ("bilstm (K6)", "dconv (K5)", "dconv tail (K4)", "int8 matmul (K7)")),
                ("--train", ["--train"], dict(per_step, dconv_sub_block=64),
                 ("attention fwd (K2)", "attention bwd (K3)", "dconv (K5)"))):
            zero()
            report = Path(tmp) / "report.json"
            _tool_json(profile_hlo.main, argv + ["--steps", "1", "--batch", str(MAIN_BATCH),
                                                 "--out", str(report), "--trace-dir", tmp])
            add(expect(f"profile_hlo {label}", times(want, 3)))
            rep = json.loads(report.read_text())
            if not (rep["device_ms_per_step"] and rep["device_ms_per_step"] > 0
                    and rep["wall_ms_per_step"] > 0
                    and all(c in rep["buckets_ms"] for c in classes)):
                raise AssertionError(f"profile_hlo {label}: {rep}")
            profiles[label] = {k: rep[k] for k in ("device_ms_per_step", "wall_ms_per_step",
                                                   "buckets_ms", "config")}
            log(f"tools: profile_hlo {label} (batch {MAIN_BATCH}): wall "
                f"{rep['wall_ms_per_step']:.1f} ms a step, device {rep['device_ms_per_step']:.1f}"
                f" ms; " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     list(rep["buckets_ms"].items())[:6]) + f" [{card}]")
    out["profile_hlo"] = profiles

    # bench_bag: 3 calls of each strategy (one untimed, two windows of --iters 1)
    zero()
    lines = _tool_json(bench_bag.main, ["--iters", "1", "--batch", str(MAIN_BATCH)])
    add(expect("bench_bag", times(v4, 2 * 3 * 4)))
    if [r["strategy"] for r in lines] != ["vmap", "sequential4"] or not all(
            r["step_s"] > 0 for r in lines):
        raise AssertionError(f"bench_bag: {lines}")
    out["bench_bag"] = lines
    log("tools: bench_bag (batch 2): " + ", ".join(
        f"{r['strategy']} {r['step_s']:.4f} s ({r['audio_s_per_s']} audio-s/s)" for r in lines)
        + f" [{lines[0]['device']}]")

    # bench_sweep: 3 calls a configuration (one untimed, --iters 2)
    zero()
    lines = _tool_json(bench_sweep.main, ["--batches", "1", "--iters", "2", "--dtypes", "f32",
                                          "--quant", "none", "int8"])
    add(expect("bench_sweep", {k: 3 * v4.get(k, 0) + 3 * v4q.get(k, 0) for k in v4q}))
    zero()
    (family,) = _tool_json(bench_sweep.main, ["--family", "--batches", "1", "--iters", "2"])
    add(counts())
    keys = ("htdemucs_4s", "htdemucs_6s", "hdemucs_v3", "ft_bag_sequential4", "ft_bag_unrolled",
            "train_step")
    if not all(r["step_s"] > 0 for r in lines) or not all(
            family[k]["step_s"] > 0 for k in keys):
        raise AssertionError(f"bench_sweep: {lines} {family}")
    out["bench_sweep"] = dict(lines=lines, family=family)
    log("tools: bench_sweep (batch 1): " + ", ".join(
        f"{r['quant']} {r['step_s']:.4f} s" for r in lines) + "; --family: " + ", ".join(
        f"{k} {family[k]['step_s']:.4f} s" for k in keys) + f" [{family['device']}]")
    out["launches"] = launches
    return out


def phase_int8_skips(card: str) -> dict:
    """INT8_SKIPS on the card: htdemucs-4s separates the 20 s track with
    the switch off and on (in turns: off, on, on, off, warm), the same
    launches per segment batch, the on result within the JAX test's gate
    of the off one (tests/test_quant.py: ||on - off|| / ||off|| under
    0.035, and above 0), with each one's peak memory of a call; and
    memory_report's activation bytes of one segment batch, off and on."""
    import numpy as np
    import torch

    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model, htdemucs
    from demucs_tpu_torch.ops.cuda import KERNELS
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.tools import memory_report

    cfg, schema, per_batch = _family("htdemucs_4s")
    sep = Separator(build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda"),
                    cfg.num_sources, ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337),
                    "cuda")
    track = synthetic_track(int(TRACK_SECS * SAMPLE_RATE))
    result, walls, peak, launches, memory = {}, {False: [], True: []}, {}, {}, {}
    try:
        for on in (False, True):
            htdemucs.INT8_SKIPS = on
            for kernel in KERNELS:
                kernel.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            result[on] = sep(track)
            peak[on] = torch.cuda.max_memory_allocated() - base
            launches[on] = {k.__name__: k.launches for k in KERNELS}
            memory[on] = memory_report.compiled_memory("4s", MAIN_BATCH, dtype=torch.float32)
        for on in (False, True, True, False):
            htdemucs.INT8_SKIPS = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sep(track)
            torch.cuda.synchronize()
            walls[on].append(time.perf_counter() - t0)
    finally:
        htdemucs.INT8_SKIPS = False
    del sep
    torch.cuda.empty_cache()
    n_batches = launches[False]["flash_mha"] // per_batch["flash_mha"]
    if launches[True] != launches[False] or launches[False] != {
            k: n_batches * v for k, v in per_batch.items()}:
        raise AssertionError(f"INT8_SKIPS launches: off {launches[False]}, on {launches[True]}")
    err = float(np.linalg.norm(result[True] - result[False]) / np.linalg.norm(result[False]))
    if not 0 < err < INT8_SKIPS_GATE:
        raise AssertionError(f"INT8_SKIPS: ||on - off|| / ||off|| = {err}")
    out = dict(rel_err=err, gate=INT8_SKIPS_GATE, launches=launches[True],
               peak_bytes={"off": peak[False], "on": peak[True]},
               walls_s={"off": walls[False], "on": walls[True]},
               activation_bytes={"off": memory[False]["temp_bytes"],
                                 "on": memory[True]["temp_bytes"]},
               memory_report={"off": memory[False], "on": memory[True]})
    log(f"INT8_SKIPS: htdemucs-4s on the {TRACK_SECS:g} s track, on against off ||on - off|| / "
        f"||off|| {err:.2e} (gate {INT8_SKIPS_GATE}); peak memory of a call off "
        f"{peak[False] / 2**20:.1f} MiB, on {peak[True] / 2**20:.1f} MiB; warm wall in turns off "
        f"{' '.join(f'{t:.4f}' for t in walls[False])} s, on "
        f"{' '.join(f'{t:.4f}' for t in walls[True])} s; memory_report batch {MAIN_BATCH} f32 "
        f"activations off {memory[False]['temp_bytes'] / 2**20:.1f} MiB, on "
        f"{memory[True]['temp_bytes'] / 2**20:.1f} MiB [{card}]")
    return out


ACCEPT_MIN_DB = 40.0     # cross-implementation SDR every stem must reach (tests/test_tools.py:172)
# (ggml file, kind, init_flat seed, also --orbax) of the acceptance
# phase's checkpoints; ft/ holds the bag's four models
ACCEPT_CHECKPOINTS = (("htdemucs_4s.bin", "htdemucs_4s", 0, False),
                      ("htdemucs_6s.bin", "htdemucs_6s", 0, False),
                      ("hdemucs_mmi.bin", "hdemucs_mmi", 0, True),
                      *((f"ft/ggml-model-htdemucs_ft_{stem}-f16.bin", "htdemucs_4s", 10 + i, False)
                        for i, stem in enumerate(("drums", "bass", "other", "vocals"))))


def phase_acceptance(card: str) -> dict:
    """The tier-4 acceptance gate on the card, on a machine without JAX:
      * checkpoints: seeded full-width weights (params.init_flat) of
        htdemucs-4s, htdemucs-6s, hdemucs_mmi and the fine-tuned bag's four
        htdemucs-4s models (seeds 10-13, ggml-model-htdemucs_ft_{stem}-f16.bin),
        each saved as a .th checkpoint ({"state": ...}) and converted by
        tools/convert_pth_to_ggml (hdemucs_mmi also with --orbax, the
        port's checkpoint directory); each output, loaded with
        load_model_params, equals the fp16-rounded checkpoint exactly;
      * the gate: tools/sdr_acceptance (the port's CLI against the torch
        oracle through the port's Separator, the oracle under
        f32_precision) on the 20 s track at the default segment on cuda,
        for htdemucs-4s, htdemucs-6s, hdemucs_mmi and --ft-dir; each report
        must pass and every stem reach ACCEPT_MIN_DB; the kernels launched
        (the CLI's: the oracle is plain torch) must be _family's per
        segment batch (four times for the bag) times the CLI's batches;
      * the htdemucs-4s gate once more with the oracle's forward outside
        f32_precision (TF32 convolutions under torch's default flags), its
        SDRs recorded beside the f32 ones.
    The checkpoints and stems live in a temporary directory, removed."""
    import numpy as np
    import torch

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.params import init_flat, load_model_params
    from demucs_tpu_torch.pipeline import ApplyOptions
    from demucs_tpu_torch.tools import convert_pth_to_ggml, sdr_acceptance, torch_inference

    t_phase = time.monotonic()
    n = int(TRACK_SECS * SAMPLE_RATE)
    # the CLI's segment batches: its default --batch, as the tool runs it
    batch = cli._parse(["model", "in.wav", "out"]).batch
    opts = ApplyOptions(batch_size=batch, shift_offset=1337)
    shifted = n + int(opts.max_shift_secs * SAMPLE_RATE) - 1337
    n_segments = math.ceil(shifted / int((1 - opts.overlap) * opts.segment_samples))
    n_batches = math.ceil(n_segments / batch)
    out: dict = {"card": card, "segments": n_segments, "cli_batch": batch,
                 "cudnn_allow_tf32_outside": torch.backends.cudnn.allow_tf32,
                 "checkpoints": {}, "gate": {}}
    with tempfile.TemporaryDirectory(prefix="acceptance_") as tmp:
        tmp = Path(tmp)
        ft = tmp / "ft"
        ft.mkdir()
        for label, kind, seed, orbax in ACCEPT_CHECKPOINTS:
            _, schema, _ = _family(kind)
            flat = init_flat(schema, seed=seed)
            ckpt = tmp / "model.th"
            torch.save({"state": {k: torch.from_numpy(v) for k, v in flat.items()}}, ckpt)
            ggml = tmp / label
            outputs = [ggml] + ([tmp / f"{kind}_checkpoint"] if orbax else [])
            t0 = time.monotonic()
            for path in outputs:
                argv = [str(ckpt), str(path), "--kind", kind] + (["--orbax"] if path != ggml
                                                                 else [])
                if convert_pth_to_ggml.main(argv) != 0:
                    raise RuntimeError(f"convert_pth_to_ggml {argv} failed")
            convert_s = time.monotonic() - t0
            ckpt.unlink()
            for path in outputs:
                _, sd = load_model_params(path)
                bad = [k for k, v in flat.items() if tuple(sd[k].shape) != v.shape or not
                       np.array_equal(sd[k].numpy(), v.astype(np.float16).astype(np.float32))]
                if bad or set(sd) != set(flat):
                    raise AssertionError(f"acceptance: {path.name} differs from the fp16-rounded "
                                         f"{label} checkpoint in {bad[:5]} ({len(bad)} tensors)")
            out["checkpoints"][label] = dict(kind=kind, seed=seed, tensors=len(flat),
                                             outputs=[p.name for p in outputs],
                                             convert_s=convert_s)
        log(f"acceptance: converted {len(ACCEPT_CHECKPOINTS)} .th checkpoints with "
            f"convert_pth_to_ggml (hdemucs_mmi also --orbax), each output equal to the "
            f"fp16-rounded weights; " + ", ".join(
                f"{k} {v['convert_s']:.1f} s" for k, v in out["checkpoints"].items()))

        wav = tmp / "mix.wav"
        audio.write_wav(wav, synthetic_track(n))
        for label, select, kind, models in (
                ("htdemucs_4s", [str(tmp / "htdemucs_4s.bin")], "htdemucs_4s", 1),
                ("htdemucs_6s", [str(tmp / "htdemucs_6s.bin")], "htdemucs_6s", 1),
                ("hdemucs_mmi", [str(tmp / "hdemucs_mmi.bin")], "hdemucs_mmi", 1),
                ("htdemucs_ft bag", ["--ft-dir", str(ft)], "htdemucs_4s", 4)):
            argv = select + [str(wav), "--device", "cuda"]
            _reset_launches()
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = sdr_acceptance.main(argv)
            wall = time.monotonic() - t0
            launches, _ = _launches()
            lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
            report = json.loads(lines[-1]) if lines else None
            if rc != 0 or not report or not report["pass"]:
                raise AssertionError(f"sdr_acceptance {label}: exit {rc}, report {report}")
            sdr = {stem: entry["cross_impl_sdr_db"] for stem, entry in report.items()
                   if stem != "pass"}
            low = {stem: db for stem, db in sdr.items() if db is None or db < ACCEPT_MIN_DB}
            if low:
                raise AssertionError(f"sdr_acceptance {label}: stems under {ACCEPT_MIN_DB} dB: "
                                     f"{low}")
            want = {k: models * v * n_batches for k, v in _family(kind)[2].items()}
            if launches != want:
                raise AssertionError(f"sdr_acceptance {label}: launched {launches}, want {want}")
            for stem, db in sdr.items():
                log(f"acceptance {label} {stem}: cross-implementation SDR {db} dB [{card}]")
            out["gate"][label] = dict(report=report, sdr_db=sdr, wall_s=wall, launches=launches)
            log(f"acceptance {label}: pass, {wall:.1f} s (the CLI and the oracle, cold), "
                f"launches {({k: v for k, v in launches.items() if v})} [{card}]")

        # what the oracle's f32 scope guards against: the htdemucs-4s gate
        # again with the oracle under torch's default flags (cuDNN's
        # convolutions in TF32); recorded, not gated
        scoped = torch_inference.F32Oracle.forward
        torch_inference.F32Oracle.forward = lambda self, mix: self.model(mix)
        try:
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                sdr_acceptance.main([str(tmp / "htdemucs_4s.bin"), str(wav), "--device", "cuda"])
        finally:
            torch_inference.F32Oracle.forward = scoped
        report = json.loads(buf.getvalue().splitlines()[-1])
        out["oracle_tf32"] = {stem: entry["cross_impl_sdr_db"] for stem, entry in report.items()
                              if stem != "pass"}
        log(f"acceptance htdemucs_4s with the oracle in TF32 (default cuDNN flags): "
            f"cross-implementation SDR {out['oracle_tf32']} dB, against "
            f"{out['gate']['htdemucs_4s']['sdr_db']} dB with TF32 off [{card}]")
    out["phase_s"] = time.monotonic() - t_phase
    return out


MULTI_RANKS = 2          # ranks of the multi-rank phase, sharing cuda:0 under gloo
MULTI_TOL = 1e-5         # a multi-rank run's stems against one process's, of max(scale, 1)
MULTI_TIMEOUT = 600      # s: a rank that hangs fails the phase
# (label, CLI flags, family): each run through the CLI's rank body, the
# mesh from --tp over the 2 ranks (dp = 2 / tp)
MULTI_RUNS = (
    ("htdemucs_4s dp=2", [], "htdemucs_4s"),
    ("htdemucs_4s tp=2", ["--tp", "2"], "htdemucs_4s"),
    ("htdemucs_4s --int8 tp=2", ["--int8", "--tp", "2"], "htdemucs_4s"),
    ("hdemucs_mmi dp=2", [], "hdemucs_mmi"),
)
MULTI_TRAIN = (("tp=2", 2), ("dp=2", 1))   # (label, tp) of the training steps


def _multi_cli_args(tmp: Path, kind: str, outdir: Path, flags: list[str]) -> list[str]:
    return [str(tmp / f"{kind}.bin"), str(tmp / "mix.wav"), str(outdir),
            "--batch", str(MAIN_BATCH), "--offset", "1337", *flags]


def _multi_rank_worker(rank: int, world: int, ports: list[int], tmp: str) -> None:
    """One rank of phase_multi_rank, spawned; both ranks run on cuda:0 and
    talk through gloo (NCCL refuses two ranks on one device). Each run of
    MULTI_RUNS goes through the CLI's rank body (`cli.rank_main`, its own
    process group) on the 20 s track, the launch counts set to 0 just
    before it and read just after; then one full-width htdemucs-4s
    training step at tp=2 and at dp=2 (`train.ShardedTrainStep`) on the
    batch the parent saved, the gradients gathered, rank 0 saving them.
    Writes rank{rank}.json to tmp."""
    import torch
    import torch.distributed as dist

    from demucs_tpu_torch import cli
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.parallel import (axis_group, gather_state_dict, init_distributed,
                                           make_mesh, shard_state_dict)
    from demucs_tpu_torch.params import from_state_dict, init_flat
    from demucs_tpu_torch.train import ShardedTrainStep

    tmp = Path(tmp)
    out: dict = {"runs": {}, "training": {}}
    for (label, flags, kind), port in zip(MULTI_RUNS, ports):
        outdir = tmp / ("ranks " + label).replace(" ", "_")
        args = cli._parse(_multi_cli_args(tmp, kind, outdir, flags))
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.rank_main(rank, world, args, f"tcp://127.0.0.1:{port}", backend="gloo")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, _ = _launches()
        if rc:
            raise RuntimeError(f"{label}: rank {rank} exited {rc}")
        out["runs"][label] = dict(wall_s=wall, launches=counts)

    init_distributed(rank, world, f"tcp://127.0.0.1:{ports[-1]}", "cuda", backend="gloo")
    try:
        cfg, schema, _ = _family("htdemucs_4s")
        sd = from_state_dict(init_flat(schema, seed=0), schema)
        batch = torch.load(tmp / "train_batch.pt")
        mix, refs = batch["mix"].cuda(), batch["refs"].cuda()
        for label, tp in MULTI_TRAIN:
            mesh = make_mesh(tp=tp, device_type="cuda")
            model = build_model(cfg, shard_state_dict(sd, mesh), "cuda", train=True,
                                tp_group=axis_group(mesh, "tp"))
            step = ShardedTrainStep(model, mesh)
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loss = step(mix, refs).item()
            wall = time.monotonic() - t0
            counts, _ = _launches()
            grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()}, mesh)
            if rank == 0:
                torch.save({n: g.detach().cpu() for n, g in grads.items()},
                           tmp / f"grads {label}.pt")
            out["training"][label] = dict(loss=loss, wall_s=wall, launches=counts)
            del step, model, grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (tmp / f"rank{rank}.json").write_text(json.dumps(out))


def _grad_gap(grads: dict, ref: dict) -> tuple[float, str, float]:
    """(worst |g - ref| / |ref| over the tensors, its name, the largest
    difference of the GroupNorm-removed bias gradient means), as
    phase_reference_training compares gradients."""
    from demucs_tpu_torch.models import feeds_group_norm

    rels, residue = [], 0.0
    for name, r in ref.items():
        g = grads[name].double()
        r = r.double()
        if feeds_group_norm(name):
            residue = max(residue, abs(g.mean().item() - r.mean().item()))
            g, r = g - g.mean(), r - r.mean()
        norm = r.norm().item()
        rels.append(((g - r).norm().item() / norm if norm > 0 else (g - r).norm().item(), name))
    worst, name = max(rels)
    return worst, name, residue


def multi_rank_shapes(name, rows, train_rows, lstm_rows, dconv_rows, int8_rows) -> list:
    """The kernels line's rows of kernel `name` at a rank's shapes in
    phase_multi_rank's runs (f32, htdemucs-4s's D=64): K1 on (1, 8, T, 64)
    at dp=2 and (2, 4, T, 64) at tp=2, K2 and K3 on (1, 8, T, 64) and
    (2, 4, T, 64) in the training steps, K7 at a rank's (K, N) under
    --int8 --tp 2, K5 on one segment at dp=2 (and two in the tp=2 training
    step), K6 and K4 on one at dp=2. Each: the error over the call's
    shapes (held to TOL in its phase), the slowest call's ms, plain_ms,
    bound and library time."""
    def attn(rs, H, B, kern=None):
        return [r for r in rs if r["dtype"] == "float32" and r["D"] == 64 and r["H"] == H
                and r["B"] == B and r.get("kernel") == kern]

    def k5(family, B):
        return [r for r in dconv_rows if r["kernel"] == "K5" and r["family"] == family
                and r["B"] == B]

    dp_b, train_dp_b = MAIN_BATCH // MULTI_RANKS, MULTI_TRAIN_BATCH // MULTI_RANKS
    calls = {
        "flash_mha": {"htdemucs_4s dp=2": attn(rows, HEADS, dp_b),
                      "htdemucs_4s tp=2, --int8 tp=2": attn(rows, TP_HEADS, MAIN_BATCH)},
        "flash_mha_fwd": {"training dp=2": attn(train_rows, HEADS, train_dp_b, "K2"),
                          "training tp=2": attn(train_rows, TP_HEADS, MULTI_TRAIN_BATCH, "K2")},
        "flash_mha_bwd": {"training dp=2": attn(train_rows, HEADS, train_dp_b, "K3"),
                          "training tp=2": attn(train_rows, TP_HEADS, MULTI_TRAIN_BATCH, "K3")},
        "int8_matmul": {"htdemucs_4s --int8 tp=2": [
            r for r in int8_rows if r["family"] == "htdemucs_4s tp=2" and r["B"] == MAIN_BATCH]},
        "dconv_sub_block": {"htdemucs_4s dp=2": k5("htdemucs_4s", dp_b),
                            "hdemucs_mmi dp=2": k5("hdemucs_mmi", dp_b),
                            "training dp=2": k5("htdemucs_4s", train_dp_b),
                            "training tp=2": k5("htdemucs_4s", MULTI_TRAIN_BATCH)},
        "bilstm_recurrence": {"hdemucs_mmi dp=2": [r for r in lstm_rows if r["B"] == dp_b]},
        "gn_glu_scale_res": {"hdemucs_mmi dp=2": [r for r in dconv_rows
                                                  if r["kernel"] == "K4" and r["B"] == dp_b]},
    }.get(name, {})
    out = []
    for run, rs in calls.items():
        if not rs:
            raise AssertionError(f"{name}: no rows at the per-rank shapes of {run}")
        head = max(rs, key=lambda r: r["ms"])
        if "H" in head and "T" in head and "S" in head:
            shape = f"q ({head['B']},{head['H']},{head['T']},{head['D']}), S={head['S']}"
        elif "M" in head:
            shape = f"x ({head['M']},{head['K']}) f32, q ({head['N']},{head['K']}) int8"
        elif "shape" in head:
            shape = head["shape"]
        else:
            shape = f"xs ({head['T']},2,{head['B']},{4 * head['H']}) float32"
        out.append(dict(run=run, shape=shape, calls=len(rs),
                        max_abs_err=max(r["err"] for r in rs), ms=head["ms"],
                        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                        bound_by=head["bound_by"], library_ms=head.get("library_ms")))
    return out


def phase_multi_rank(card: str) -> dict:
    """The multi-card path on one card: 2 ranks spawned with
    torch.multiprocessing, sharing cuda:0 under gloo (which measures that
    the distributed path is right, not how it scales). Through the CLI's
    rank body on the full-width 20 s track: htdemucs-4s at dp=2 (K1 on
    (1, 8, T, 64) a rank) and tp=2 (K1 on (2, 4, T, 64), the transformer's
    partial products all-reduced), --int8 at tp=2 (K7 at K = 256 for the
    output projections), hdemucs_mmi at dp=2 (K6, K5, K4); every rank's
    launches per segment batch asserted, and rank 0's stems held against
    the single-process CLI's within MULTI_TOL of scale. Then one full-width
    htdemucs-4s training step at tp=2 and at dp=2 (K2, K3, K5) against the
    one-process step: loss and every gathered gradient at the GPU-vs-CPU
    training tolerances. Last, a 1-rank NCCL mesh in this process:
    ShardedSeparator against Separator, bit for bit. A failed rank fails
    the phase."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from demucs_tpu_torch import audio, cli
    from demucs_tpu_torch.config import SAMPLE_RATE
    from demucs_tpu_torch.models import build_model
    from demucs_tpu_torch.parallel import (ShardedSeparator, free_port, init_distributed,
                                           make_mesh)
    from demucs_tpu_torch.params import from_state_dict, init_flat, write_ggml
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.train import TrainStep

    n = int(TRACK_SECS * SAMPLE_RATE)
    opts = ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337)
    shifted = n + int(opts.max_shift_secs * SAMPLE_RATE) - 1337
    n_batches = math.ceil(math.ceil(shifted / int((1 - opts.overlap) * opts.segment_samples))
                          / MAIN_BATCH)
    summary: dict = {"ranks": MULTI_RANKS, "backend": "gloo on CUDA tensors, one card",
                     "runs": {}, "training": {}}
    t_phase = time.monotonic()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        track = synthetic_track(n)
        audio.write_wav(tmp / "mix.wav", track)
        sds = {}
        for kind in ("htdemucs_4s", "hdemucs_mmi"):
            _, schema, _ = _family(kind)
            flat = init_flat(schema, seed=0)
            write_ggml(tmp / f"{kind}.bin", kind, flat)
            sds[kind] = from_state_dict(flat, schema)

        # the one-process references: the CLI in this process
        single = {}
        for label, flags, kind in MULTI_RUNS:
            key = (kind, "--int8" in flags)
            if key not in single:
                outdir = tmp / f"single_{kind}_{key[1]}"
                # --no-mesh: one process whatever the number of cards visible
                args = _multi_cli_args(tmp, kind, outdir,
                                       ["--no-mesh"] + (["--int8"] if key[1] else []))
                if cli.main(args) != 0:
                    raise RuntimeError(f"single-process CLI {args} failed")
                cfg, _, _ = _family(kind)
                single[key] = np.stack([audio.load_track(outdir / f"target_{i}_{s}.wav")
                                        for i, s in enumerate(cfg.sources)])

        # the one-process training step, on references drawn away from the
        # estimate (phase_reference_training says why)
        cfg4, _, _ = _family("htdemucs_4s")
        rng = np.random.default_rng(7)
        mix = np.stack([track[:, i * 1000:i * 1000 + opts.segment_samples]
                        for i in range(MULTI_TRAIN_BATCH)])
        model = build_model(cfg4, sds["htdemucs_4s"], "cuda", train=True)
        with torch.no_grad():
            est = model(torch.from_numpy(mix).cuda()).cpu().numpy()
        sign = np.sign(rng.standard_normal(est.shape))
        refs = (est + sign * (0.1 + 0.4 * rng.random(est.shape))).astype(np.float32)
        step = TrainStep(model)
        loss_ref = step(torch.from_numpy(mix).cuda(), torch.from_numpy(refs).cuda()).item()
        grads_ref = {nm: p.grad.detach().cpu() for nm, p in model.named_parameters()}
        del step, model
        torch.cuda.empty_cache()
        torch.save({"mix": torch.from_numpy(mix), "refs": torch.from_numpy(refs)},
                   tmp / "train_batch.pt")

        # the ranks
        ports = [free_port() for _ in range(len(MULTI_RUNS) + 1)]
        t0 = time.monotonic()
        ranks = torch.multiprocessing.start_processes(
            _multi_rank_worker, args=(MULTI_RANKS, ports, str(tmp)), nprocs=MULTI_RANKS,
            join=False, start_method="spawn")
        deadline = time.monotonic() + MULTI_TIMEOUT
        try:
            while not ranks.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {MULTI_TIMEOUT} s")
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
        summary["ranks_wall_s"] = time.monotonic() - t0
        per_rank = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(MULTI_RANKS)]

        for label, flags, kind in MULTI_RUNS:
            _, _, per_batch = _family(kind, "int8" if "--int8" in flags else None)
            want = {k: c * n_batches for k, c in per_batch.items()}
            for r, res in enumerate(per_rank):
                got = res["runs"][label]["launches"]
                if got != want:
                    raise AssertionError(f"{label} rank {r}: launches {got}, expected {want}")
            cfg, _, _ = _family(kind)
            outdir = tmp / ("ranks " + label).replace(" ", "_")
            stems = np.stack([audio.load_track(outdir / f"target_{i}_{s}.wav")
                              for i, s in enumerate(cfg.sources)])
            ref = single[(kind, "--int8" in flags)]
            scale = max(float(np.abs(ref).max()), 1.0)
            err = float(np.abs(stems - ref).max())
            rec = dict(max_abs_diff=err, scale=scale, rel=err / scale,
                       bit_identical=err == 0.0,
                       wall_s=[res["runs"][label]["wall_s"] for res in per_rank],
                       launches_per_rank=[res["runs"][label]["launches"] for res in per_rank],
                       launches_per_segment_batch={k: c for k, c in per_batch.items() if c})
            summary["runs"][label] = rec
            log(f"multi-rank {label}: rank 0's stems vs one process {err:.3e} "
                f"(scale {scale:.3f}, rel {err / scale:.2e}, tolerance {MULTI_TOL:g}); "
                f"launches per rank per segment batch {rec['launches_per_segment_batch']} x "
                f"{n_batches} batches; wall {', '.join(f'{w:.2f}' for w in rec['wall_s'])} s "
                f"[{card}]")
            if not np.isfinite(stems).all() or stems.shape != ref.shape:
                raise AssertionError(f"{label}: stems {stems.shape} not finite or not "
                                     f"of {ref.shape}")
            if not err <= MULTI_TOL * scale:
                raise AssertionError(f"{label}: rank 0's stems differ from one process's by "
                                     f"{err} (scale {scale})")

        _, _, per_batch = _family("htdemucs_4s")
        attn = per_batch.pop("flash_mha")
        want = dict(per_batch, flash_mha=0, flash_mha_fwd=attn, flash_mha_bwd=attn)
        for label, _ in MULTI_TRAIN:
            grads = torch.load(tmp / f"grads {label}.pt")
            worst, worst_name, residue = _grad_gap(grads, grads_ref)
            top = max(g.abs().max().item() for g in grads_ref.values())
            losses = [res["training"][label]["loss"] for res in per_rank]
            rec = dict(loss=losses, loss_one_process=loss_ref,
                       loss_rel_err=abs(losses[0] - loss_ref) / loss_ref,
                       worst_grad_rel_err=worst, worst_grad=worst_name,
                       groupnorm_mean_residue=residue,
                       wall_s=[res["training"][label]["wall_s"] for res in per_rank],
                       launches_per_rank=[res["training"][label]["launches"]
                                          for res in per_rank])
            summary["training"][label] = rec
            log(f"multi-rank training {label}: loss {losses} vs one process {loss_ref:.8f} "
                f"(rel {rec['loss_rel_err']:.2e}); worst gradient |diff|/|ref| {worst:.2e} "
                f"({worst_name}); launches per rank {rec['launches_per_rank'][0]}; "
                f"step {', '.join(f'{w:.2f}' for w in rec['wall_s'])} s [{card}]")
            for r, res in enumerate(per_rank):
                got = res["training"][label]["launches"]
                if got != want:
                    raise AssertionError(f"training {label} rank {r}: launches {got}, "
                                         f"expected {want}")
            if len(set(losses)) != 1:
                raise AssertionError(f"training {label}: the ranks' losses differ: {losses}")
            if not (rec["loss_rel_err"] <= TRAIN_REF_LOSS_TOL and worst <= TRAIN_REF_GRAD_TOL
                    and residue <= TRAIN_REF_GRAD_TOL * top):
                raise AssertionError(f"training {label} against one process: {rec}")

        # a 1-rank NCCL mesh in this process: ShardedSeparator is Separator
        init_distributed(0, 1, f"tcp://127.0.0.1:{free_port()}", "cuda")
        try:
            backend = dist.get_backend()
            model = build_model(cfg4, sds["htdemucs_4s"], "cuda")
            a = Separator(model, cfg4.num_sources, opts, "cuda")(track)
            b = ShardedSeparator(model, cfg4.num_sources, make_mesh(), opts,
                                 device="cuda")(track)
        finally:
            dist.destroy_process_group()
        if backend != "nccl" or not np.array_equal(a, b):
            raise AssertionError(f"1-rank {backend} mesh: ShardedSeparator differs from "
                                 f"Separator by {float(np.abs(a - b).max())}")
        summary["nccl_one_rank"] = dict(backend=backend, bit_identical=True)
        log(f"multi-rank: a 1-rank {backend} mesh's ShardedSeparator equals Separator bit for "
            "bit on the 20 s track")
    summary["wall_s"] = time.monotonic() - t_phase
    return summary


PAIR_REPS = 3   # timed warm calls per probe, after one untimed


def probe(root: str) -> None:
    """--probe ROOT: with the demucs_tpu_torch of the checkout ROOT, the
    warm separation of the 20 s track by both families and by htdemucs-4s
    through the fused pass (times, peak memory, one profiled call), the
    warm training step of htdemucs-4s at
    batch 4 (times, peak memory, one profiled step) and K5 alone at every
    DConv shape of both families at B = 2 (CUDA events, dilations 1 and
    2), K7 alone at every linear shape of both families' --int8 paths and
    K4 alone at both v3 tails, both at B = 2; one JSON line. Uses only what
    every slice of the port has."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import demucs_tpu_torch
    from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S, SAMPLE_RATE, SEGMENT_SAMPLES
    from demucs_tpu_torch.data import augmented_step, draw_augmentation
    from demucs_tpu_torch.models import build_htdemucs, build_model
    from demucs_tpu_torch.ops.cuda import build
    from demucs_tpu_torch.params import (from_state_dict, hdemucs_v3_schema, htdemucs_schema,
                                         init_flat)
    from demucs_tpu_torch.pipeline import ApplyOptions, Separator
    from demucs_tpu_torch.train import TrainStep

    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    result = {"package": str(Path(demucs_tpu_torch.__file__).resolve().parent)}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(PAIR_REPS):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_device(fn, "one more call")
        return dict(times_s=times, median_s=statistics.median(times), peak_bytes=peak,
                    device_kernels=prof.get("device_kernels"),
                    busy_share=prof.get("busy_share"), device_ms=prof.get("device_ms"))

    track = synthetic_track(int(TRACK_SECS * SAMPLE_RATE))
    for kind, cfg, schema in (("htdemucs_4s", HTDEMUCS_4S, htdemucs_schema(HTDEMUCS_4S)),
                              ("hdemucs_mmi", HDEMUCS_V3, hdemucs_v3_schema(HDEMUCS_V3))):
        model = build_model(cfg, from_state_dict(init_flat(schema, seed=0), schema), "cuda")
        sep = Separator(model, cfg.num_sources,
                        ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337), "cuda")
        result[kind] = timed(lambda: sep(track))
        if kind == "htdemucs_4s":
            fused = Separator(model, cfg.num_sources,
                              ApplyOptions(batch_size=MAIN_BATCH, shift_offset=1337,
                                           fused_track=True), "cuda")
            result["htdemucs_4s_fused"] = timed(lambda: fused(track))
            del fused
        del sep, model
        torch.cuda.empty_cache()

    schema = htdemucs_schema(HTDEMUCS_4S)
    model = build_htdemucs(HTDEMUCS_4S, from_state_dict(init_flat(schema, seed=0), schema),
                           "cuda", train=True)
    step = TrainStep(model, ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stems = 0.05 * torch.randn(TRAIN_BATCH, HTDEMUCS_4S.num_sources, 2, SEGMENT_SAMPLES,
                               device="cuda", generator=gen)
    step_fn = lambda: augmented_step(step, stems, draw_augmentation(stems.shape, gen))  # noqa: E731
    step_fn()
    result["training"] = timed(step_fn)
    del step, model, stems
    torch.cuda.empty_cache()

    from demucs_tpu_torch.ops.cuda import dconv_sub_block
    from demucs_tpu_torch.utils.device import f32_precision

    result["dconv_ms"] = {}
    with torch.inference_mode(), f32_precision():
        for kind, comp in DCONV_COMP.items():
            for level, N, C, T in dconv_shapes(MAIN_BATCH):
                h = C // comp
                x = torch.randn(N, C, T, device="cuda", generator=gen)
                ws = [torch.randn(*shape, device="cuda", generator=gen) * 0.3
                      for shape in ((h, C, 3), (h,), (h,), (h,), (2 * C, h, 1), (2 * C,),
                                    (2 * C,), (2 * C,), (C,))]
                for dil in (1, 2):
                    result["dconv_ms"][f"{kind} {level} dil={dil}"] = time_ms(
                        lambda: dconv_sub_block(x, *ws, dil), 10)
                del x, ws

    from demucs_tpu_torch.ops.cuda import gn_glu_scale_res, int8_matmul

    result["int8_ms"], result["tail_ms"], result["int8_device_ms"] = {}, {}, {}
    result["tail_device_ms"] = {}
    with torch.inference_mode(), f32_precision():
        for family, B, M, K, N in int8_shapes():
            if B == MAIN_BATCH:
                x, q, scale, b = _int8_operands(gen, M, N, K)
                s = scale.reshape(-1)
                key = f"{family} M={M} K={K} N={N}"
                result["int8_ms"][key] = time_ms(lambda: int8_matmul(x, q, s, b), 20)
                result["int8_device_ms"][key] = profiled_ms(
                    lambda: int8_matmul(x, q, s, b), 20, ("int8_matmul",))
        for C, T in TAIL_SHAPES:
            args = [torch.randn(*shape, device="cuda", generator=gen)
                    for shape in ((MAIN_BATCH, 2 * C, T), (2 * C,), (2 * C,), (C,),
                                  (MAIN_BATCH, C, T))]
            result["tail_ms"][f"C={C} T={T}"] = time_ms(lambda: gn_glu_scale_res(*args), 20)
            result["tail_device_ms"][f"C={C} T={T}"] = profiled_ms(
                lambda: gn_glu_scale_res(*args), 20, ("gn_glu_",))
    print(json.dumps({"probe": result}), flush=True)


def pair(base: str) -> int:
    """--pair BASE: probe the checkout BASE, this one, this one again and
    BASE again, each in a process of its own, on this one card."""
    card = card_line()
    log(card)
    here = str(Path(__file__).resolve().parent)
    results = []
    for label, root in (("base", base), ("change", here), ("change", here), ("base", base)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--probe", root],
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines()[:-1]:
            log(f"  [{label}] {line}")
        if proc.returncode:
            raise RuntimeError(f"probe of {root} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        results.append((label, json.loads(proc.stdout.splitlines()[-1])["probe"]))
    log(f"{'run':>6} {'what':>17} {'median_s':>9} {'times_s':>26} {'kernels':>8} "
        f"{'busy':>6} {'device_ms':>9} {'peak_GB':>8}")
    for label, r in results:
        for what in ("htdemucs_4s", "htdemucs_4s_fused", "hdemucs_mmi", "training"):
            m = r[what]
            log(f"{label:>6} {what:>17} {m['median_s']:>9.4f} "
                f"{' '.join(f'{t:.4f}' for t in m['times_s']):>26} {m['device_kernels']:>8} "
                f"{m['busy_share']:>6.1%} {m['device_ms']:>9.1f} {m['peak_bytes'] / 1e9:>8.2f}")
    log(f"K5 alone at B={MAIN_BATCH}, ms (CUDA events) in the four runs: "
        + " ".join(label for label, _ in results))
    for key in results[0][1]["dconv_ms"]:
        log(f"  {key:>28} " + " ".join(f"{r['dconv_ms'][key]:>8.4f}" for _, r in results))
    log(f"K7 and K4 alone at B={MAIN_BATCH}, ms per call in the four runs (CUDA events over "
        f"back-to-back calls, then torch.profiler's device time)")
    for what in ("int8_ms", "tail_ms", "int8_device_ms", "tail_device_ms"):
        for key in results[0][1][what]:
            log(f"  {key:>40} " + " ".join(f"{_ms(r[what][key]):>8}" for _, r in results))
    log(json.dumps({"pair": [dict(run=label, **r) for label, r in results], "card": card}))
    return 0


def stream_calls_entry(rows) -> dict:
    """The kernels line's summary of a kernel's rows at B = 1 (a --stream
    call of one ready segment): the largest error, and each call's times
    and, for K5, its plan."""
    def call(r):
        text = f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
        if "cluster" in r:
            text += (f"; {r['form']}, {r['cluster']} block(s) of {r['threads']} threads, "
                     f"{r['launches_per_call']} CUDA launch(es), shared bytes "
                     f"{r['shared_bytes']}")
        elif "form" in r:
            text += f"; {r['form']}"
        return text

    return {"max_abs_err": max(r["err"] for r in rows),
            "calls": {f"{r['family']} {r['level']}" + (f" dil={r['dil']}" if "dil" in r else "")
                      + f" {r['shape']}": call(r) for r in rows}}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if argv[:1] == ["--probe"] and len(argv) == 2:
        probe(argv[1])
        return 0
    if argv[:1] == ["--pair"] and len(argv) == 2:
        return pair(argv[1])
    if argv:
        print("usage: chip_smoke.py [--pair DIR]", file=sys.stderr)
        return 2
    from demucs_tpu_torch.ops.cuda import build, dconv, flash_attention, lstm, quant_matmul

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    sources = flash_attention.SOURCES + lstm.SOURCES + dconv.SOURCES + quant_matmul.SOURCES
    secs = build.build(sources, force=True)
    log(f"built kernels {', '.join(sources)} from csrc/ in {secs:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    hgmma = sass_hgmma(flash_attention.SOURCE)
    log("SASS of K1 and K2, HGMMA instructions per kernel: "
        + ", ".join(f"{k} {n}" for k, n in sorted(hgmma.items())))
    if len(hgmma) != 8 or not all(hgmma.values()):
        raise AssertionError(f"every instantiation of K1 and K2 must issue HGMMA: {hgmma}")
    bwd_hgmma = sass_hgmma(flash_attention.BWD_SOURCE)
    log("SASS of K3, HGMMA instructions per kernel: "
        + ", ".join(f"{k} {n}" for k, n in sorted(bwd_hgmma.items())))
    if len(bwd_hgmma) != 4 or not all(bwd_hgmma.values()):
        raise AssertionError(f"every instantiation of K3 must issue HGMMA: {bwd_hgmma}")
    # K3's registers and spills (ptxas) and its dynamic shared memory per block
    smem_bytes = build.load(flash_attention.BWD_SOURCE).flash_mha_bwd_smem_bytes
    bwd_resources = ptxas_resources(flash_attention.BWD_SOURCE)
    for name, res in bwd_resources.items():
        res["shared_bytes"] = smem_bytes(int("bf16" in name), int(name[-3:-1]))
    log("K3 resources per kernel: " + ", ".join(
        f"{k} {r['registers']} registers, {r['spill_stores']}/{r['spill_loads']} B spilled "
        f"(stores/loads), {r['shared_bytes']} B shared" for k, r in sorted(bwd_resources.items())))
    # K5's and K4's registers and spills (K5's shared bytes depend on the
    # shape: phase_dconv logs each shape's)
    dconv_resources = ptxas_resources(dconv.SOURCE, _dconv_name)
    log("K5/K4 resources per kernel: " + ", ".join(
        f"{k} {r['registers']} registers, {r['spill_stores']}/{r['spill_loads']} B spilled "
        f"(stores/loads)" for k, r in sorted(dconv_resources.items())))
    # K7: the wgmma form's instantiations must issue HGMMA, the simt form's none
    quant_hgmma = sass_hgmma(quant_matmul.SOURCE, _quant_name)
    quant_resources = ptxas_resources(quant_matmul.SOURCE, _quant_name)
    log("SASS of K7, HGMMA instructions per kernel: "
        + ", ".join(f"{k} {n}" for k, n in sorted(quant_hgmma.items())))
    log("K7 resources per kernel: " + ", ".join(
        f"{k} {r['registers']} registers, {r['spill_stores']}/{r['spill_loads']} B spilled "
        f"(stores/loads)" for k, r in sorted(quant_resources.items())))
    wgmma_hgmma = {k: n for k, n in quant_hgmma.items() if "wgmma" in k}
    if len(wgmma_hgmma) != 4 or not all(wgmma_hgmma.values()):
        raise AssertionError(f"all four instantiations of K7's wgmma form (1 and 2 "
                             f"consumers, both weight modes) must issue HGMMA: {quant_hgmma}")

    t_run = time.monotonic()

    def timed(label, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        log(f"[{label} took {time.monotonic() - t0:.1f} s, "
            f"{time.monotonic() - t_run:.1f} s in all]")
        return out

    rows = timed("K1", phase_attention)
    train_rows = timed("K2, K3", phase_training_kernels)
    lstm_rows = timed("K6", phase_lstm)
    dconv_rows = timed("K5, K4", phase_dconv)
    int8_rows = timed("K7", phase_quant_matmul)
    bf16_rows = timed("bf16 forms of K5, K4, K6 and K7's bf16-weight mode", phase_bf16_kernels)
    serving = timed("serving", phase_serving, card)
    # K4's call time since the kernels are bound as custom ops (the host
    # side of a call bounds K4): the eager wrapper's, which calls the op,
    # the op's called as torch.ops.demucs_tpu_torch.gn_glu_scale_res, and
    # the CUDA implementation's without the dispatcher
    serving["k4_call_ms"] = {f"B={r['B']} {r['level']}": dict(
        wrapper_ms=r["ms"], op_ms=r["op_ms"], impl_ms=r["impl_ms"], device_ms=r["device_ms"])
        for r in dconv_rows if r["kernel"] == "K4"}
    log("serving: K4's call time (CUDA events per call): " + ", ".join(
        f"{k} wrapper {v['wrapper_ms']:.4f} ms, torch.ops {v['op_ms']:.4f} ms, CUDA "
        f"implementation without the dispatcher {v['impl_ms']:.4f} ms (device "
        f"{_ms(v['device_ms'])})" for k, v in serving["k4_call_ms"].items()))
    launches, n_batches, summary = timed("htdemucs-4s separation", phase_main_path,
                                         card, "htdemucs_4s")
    v3_launches, v3_batches, v3_summary = timed("hdemucs_mmi separation", phase_main_path,
                                                card, "hdemucs_mmi")
    q_launches, q_batches, q_summary = timed("htdemucs-4s --int8 separation",
                                             phase_main_path, card, "htdemucs_4s", "int8")
    qv3_launches, qv3_batches, qv3_summary = timed("hdemucs_mmi --int8 separation",
                                                   phase_main_path, card, "hdemucs_mmi",
                                                   "int8")
    *_, fp8_summary = timed("htdemucs-4s --fp8 separation", phase_main_path, card,
                            "htdemucs_4s", "fp8")
    b_launches, b_batches, b_summary = timed("htdemucs-4s --bf16 separation",
                                             phase_main_path, card, "htdemucs_4s", None, True)
    bv3_launches, bv3_batches, bv3_summary = timed("hdemucs_mmi --bf16 separation",
                                                   phase_main_path, card, "hdemucs_mmi", None,
                                                   True)
    bq_launches, bq_batches, bq_summary = timed("htdemucs-4s --bf16 --int8 separation",
                                                phase_main_path, card, "htdemucs_4s", "int8",
                                                True)
    bqv3_launches, bqv3_batches, bqv3_summary = timed(
        "hdemucs_mmi --bf16 --int8 separation", phase_main_path, card, "hdemucs_mmi", "int8",
        True)
    *_, bfp8_summary = timed("htdemucs-4s --bf16 --fp8 separation", phase_main_path, card,
                             "htdemucs_4s", "fp8", True)
    *_, bv3fp8_summary = timed("hdemucs_mmi --bf16 --fp8 separation", phase_main_path, card,
                               "hdemucs_mmi", "fp8", True)
    bf16_long = timed("--bf16 long track", phase_bf16_long_track, card)
    q_summary["turns"] = timed("htdemucs-4s dense/int8 in turns", phase_int8_turns, card)
    host_summary = timed("host path", phase_host_path, card)
    host_summary["stage_timer"] = timed("stage timer", phase_stage_timer, card)
    host_summary["cli"] = timed("CLI host options", phase_cli_host, card)
    # the fine-tuned bag (--ft-dir) and streaming (--stream)
    bag_launches, bag_batches, bag_summary = timed(
        "bag separation", phase_main_path, card, "htdemucs_4s", None, False, True)
    qbag_launches, qbag_batches, qbag_summary = timed(
        "bag --int8 separation", phase_main_path, card, "htdemucs_4s", "int8", False, True)
    *_, fp8bag_summary = timed("bag --fp8 separation", phase_main_path, card, "htdemucs_4s",
                               "fp8", False, True)
    bbag_launches, bbag_batches, bbag_summary = timed(
        "bag --bf16 separation", phase_main_path, card, "htdemucs_4s", None, True, True)
    bbag_summary["bf16_repeat"] = timed("--bf16 run twice", phase_bf16_repeat, card)
    bag_summary["long_track"] = timed("bag long track", phase_bag_long_track, card)
    bag_summary["cli_host"] = timed("bag CLI host options", phase_bag_cli_host, card)
    streams = {kind: timed(f"--stream {kind}", phase_stream, card, kind)
               for kind in ("htdemucs_4s", "hdemucs_mmi", "bag")}
    native_summary = timed("native helpers", phase_native, card)
    tools_summary = timed("measuring tools", phase_tools, card)
    q_summary["int8_skips"] = timed("INT8_SKIPS", phase_int8_skips, card)
    acceptance = timed("acceptance gate", phase_acceptance, card)
    train_launches, n_steps, train_summary = timed("training", phase_training, card)
    v3_train_launches, v3_steps, v3_train_summary = timed(
        "hdemucs_mmi training", phase_training, card, "hdemucs_mmi")
    train_modes = timed("training modes", phase_training_modes, card)
    mix, est, summary["reference"] = timed("htdemucs-4s GPU vs CPU", phase_reference,
                                           "htdemucs_4s")
    v3_mix, v3_est, v3_summary["reference"] = timed("hdemucs_mmi GPU vs CPU", phase_reference,
                                                    "hdemucs_mmi")
    *_, q_summary["reference"] = timed("htdemucs-4s --int8 GPU vs CPU", phase_reference,
                                       "htdemucs_4s", "int8")
    *_, qv3_summary["reference"] = timed("hdemucs_mmi --int8 GPU vs CPU", phase_reference,
                                         "hdemucs_mmi", "int8")
    train_summary["reference"] = timed("training GPU vs CPU", phase_reference_training,
                                       "htdemucs_4s", mix, est)
    v3_train_summary["reference"] = timed("hdemucs_mmi training GPU vs CPU",
                                          phase_reference_training, "hdemucs_mmi", v3_mix,
                                          v3_est)
    b_summary["reference"] = timed("htdemucs-4s --bf16 GPU vs CPU", phase_reference_bf16,
                                   "htdemucs_4s")
    bv3_summary["reference"] = timed("hdemucs_mmi --bf16 GPU vs CPU", phase_reference_bf16,
                                     "hdemucs_mmi")
    bq_summary["reference"] = timed("htdemucs-4s --bf16 --int8 GPU vs CPU",
                                    phase_reference_bf16, "htdemucs_4s", "int8")
    bqv3_summary["reference"] = timed("hdemucs_mmi --bf16 --int8 GPU vs CPU",
                                      phase_reference_bf16, "hdemucs_mmi", "int8")
    six_summary = {}
    six_mix, six_est, six_summary["dense"] = timed("htdemucs-6s GPU vs CPU",
                                                   phase_reference, "htdemucs_6s")
    *_, six_summary["int8"] = timed("htdemucs-6s --int8 GPU vs CPU", phase_reference,
                                    "htdemucs_6s", "int8")
    six_summary["training"] = timed("htdemucs-6s training GPU vs CPU",
                                    phase_reference_training, "htdemucs_6s", six_mix, six_est)
    bag_summary["reference"] = timed("bag GPU vs CPU", phase_reference_bag)
    train_summary["determinism"] = timed("determinism", phase_determinism, card)
    multi = timed("multi-rank", phase_multi_rank, card)

    # the kernels line: each kernel at its path's largest call (freq
    # self-attention, f32, D=64, at the path's batch), with the error over
    # all its shapes on that path
    main_rows = [r for r in rows if r["dtype"] == "float32" and r["D"] == 64
                 and r["B"] == MAIN_BATCH and r["H"] == HEADS]
    head = next(r for r in main_rows if r["T"] == r["S"] == 2688)
    bf16 = next(r for r in rows if r["dtype"] == "bfloat16" and r["D"] == 64
                and r["B"] == MAIN_BATCH and r["H"] == HEADS and r["T"] == r["S"] == 2688)
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
        "form": FWD_FORM, "bound_rate": head["bound_rate"],
        "bound_cuda_core_ms": head["bound_cuda_core_ms"],
        "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "err")},
        "sass_hgmma": {k: n for k, n in hgmma.items() if k.startswith("mha_fwd_kernel")},
    }]
    for kern, name, source, line in (
            ("K2", "flash_mha_fwd", "flash_mha.cu", 183),
            ("K3", "flash_mha_bwd", "flash_mha_bwd.cu", 263)):
        path_rows = [r for r in train_rows if r["kernel"] == kern and r["dtype"] == "float32"
                     and r["D"] == 64 and r["B"] == TRAIN_BATCH and r["H"] == HEADS]
        head = next(r for r in path_rows if r["T"] == r["S"] == 2688)
        bf16 = next(r for r in train_rows if r["kernel"] == kern and r["dtype"] == "bfloat16"
                    and r["D"] == 64 and r["B"] == TRAIN_BATCH and r["H"] == HEADS
                    and r["T"] == r["S"] == 2688)
        extra = {"form": FWD_FORM,
                 "sass_hgmma": {k: n for k, n in hgmma.items() if k.startswith("mha_fwd_lse")}
                 } if kern == "K2" else {"form": BWD_FORM, "sass_hgmma": bwd_hgmma,
                                         "resources": bwd_resources}
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
            "bound_rate": head["bound_rate"], "bound_cuda_core_ms": head["bound_cuda_core_ms"],
            "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "err")},
            **extra,
        })
    # K6 at the v3 path's largest call (encoder 5, T=168, H=384, at the
    # path's batch), with the error over both of its shapes
    path_rows = [r for r in lstm_rows if r["B"] == MAIN_BATCH]
    head = max(path_rows, key=lambda r: r["ms"])
    kernels.append({
        "name": "bilstm_recurrence", "route": "cuda",
        "source": "demucs_tpu_torch/csrc/bilstm.cu",
        "replaces": "demucs_tpu/ops/pallas/lstm.py:76",
        "launches": v3_launches["bilstm_recurrence"],
        "max_abs_err": max(r["err"] for r in path_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library": "nn.LSTM(H, H, bidirectional=True), one layer (cuDNN): the whole layer",
        "port_layer_ms": head["port_layer_ms"], "projection_ms": head["projection_ms"],
        "floor_ms": head["floor_ms"], "block_floor_ms": head["block_floor_ms"],
        "timing": f"ms, library_ms, port_layer_ms: medians of {TURNS} readings in turns",
        "shape": f"xs ({head['T']},2,{MAIN_BATCH},{4 * head['H']}), "
                 f"w_hh (2,{head['H']},{4 * head['H']}) float32",
        "launches_per_segment_batch": v3_launches["bilstm_recurrence"] / v3_batches,
    })
    # K5 at its slowest call on the htdemucs-4s path (B = 2), K4 at its
    # slowest on the hdemucs_mmi path, with the error over all of each
    # kernel's path shapes; no single PyTorch call computes either
    for kern, name, family, replaces, path_launches, batches in (
            ("K5", "dconv_sub_block", "htdemucs_4s", "demucs_tpu/ops/pallas/dconv.py:108",
             launches, n_batches),
            ("K4", "gn_glu_scale_res", "hdemucs_mmi", "demucs_tpu/ops/pallas/norms.py:62",
             v3_launches, v3_batches)):
        path_rows = [r for r in dconv_rows if r["kernel"] == kern and r["family"] == family
                     and r["B"] == MAIN_BATCH]
        head = max(path_rows, key=lambda r: r["ms"])
        # B = 1, a --stream call's shapes (both families' for K5)
        stream_rows = [r for r in dconv_rows if r["kernel"] == kern and r["B"] == 1]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "demucs_tpu_torch/csrc/dconv.cu",
            "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": max(r["err"] for r in path_rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the fused function",
            "shape": f"{family} {head['level']}: {head['shape']}",
            "launches_per_segment_batch": path_launches[name] / batches,
            "launches_v3": v3_launches[name],
            "launches_training": {"htdemucs_4s": train_launches[name],
                                  "hdemucs_mmi": v3_train_launches[name]},
            "stream_calls": stream_calls_entry(stream_rows),
            **({"form": K5_FORM, "resources": {k: v for k, v in dconv_resources.items()
                                               if k.startswith("dconv")},
                "plans": {f"{r['level']} dil={r['dil']}": (
                    f"{r['form']}, {r['cluster']} block(s) of {r['threads']} threads, "
                    f"{r['launches_per_call']} CUDA launch(es), shared bytes {r['shared_bytes']}")
                    for r in path_rows if r["family"] == family}}
               if kern == "K5" else {
                   "form": K4_FORM,
                   "resources": {k: v for k, v in dconv_resources.items()
                                 if k.startswith("gn_glu")},
                   "device_ms": head["device_ms"],
                   "calls": {f"B={r['B']} {r['level']}": (
                       f"{r['ms']:.4f} ms (device {_ms(r['device_ms'])})")
                       for r in dconv_rows if r["kernel"] == "K4"}}),
        })
    # K7 at its slowest call on the htdemucs-4s --int8 path (B = 2), with
    # the error over every path shape of both families at B = 2
    path_rows = [r for r in int8_rows if r["B"] == MAIN_BATCH
                 and r["family"] in ("htdemucs_4s", "hdemucs_mmi")]
    head = max((r for r in path_rows if r["family"] == "htdemucs_4s"), key=lambda r: r["ms"])
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "demucs_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "demucs_tpu/ops/pallas/quant_matmul.py:46",
        "launches": q_launches["int8_matmul"],
        "max_abs_err": max(r["err"] for r in path_rows),
        "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library": f"{head['library']}: the faster of the plain twin's cuBLAS product and "
                   "F.linear of the widened weight (f32, TF32 off)",
        "linear_ms": head["linear_ms"],
        "shape": f"x ({head['M']},{head['K']}) f32, q ({head['N']},{head['K']}) int8",
        "launches_per_segment_batch": q_launches["int8_matmul"] / q_batches,
        "launches_v3": qv3_launches["int8_matmul"],
        "launches_v3_per_segment_batch": qv3_launches["int8_matmul"] / qv3_batches,
        "launches_by_form": {"htdemucs_4s": q_summary["launches_by_form"]["int8_matmul"],
                             "hdemucs_mmi": qv3_summary["launches_by_form"]["int8_matmul"]},
        "form": K7_FORM, "bound_rate": head["bound_rate"],
        "bound_cuda_core_ms": head["bound_cuda_core_ms"],
        "plans": {f"{r['family']} B={r['B']} M={r['M']} K={r['K']} N={r['N']}": (
            f"{r['plan']}: {r['ms']:.4f} ms; by form " + ", ".join(
                f"{f} {ms:.4f}" for f, ms in r["form_ms"].items()))
            for r in int8_rows},
        "device_ms_per_v4_int8_track": (q_summary["profile"].get("by_class_ms") or {}).get(
            "int8 matmul (K7)"),
        "sass_hgmma": quant_hgmma, "resources": quant_resources,
    })
    # the bf16 forms, each at its slowest call on its --bf16 path (B = 2),
    # with the error over all of its path shapes; K1's bf16 form from the
    # attention phase's rows
    k1_rows = [r for r in rows if r["dtype"] == "bfloat16" and r["D"] == 64
               and r["B"] == MAIN_BATCH and r["H"] == HEADS]
    head = next(r for r in k1_rows if r["T"] == r["S"] == 2688)
    kernels.append({
        "name": "flash_mha_bf16", "route": "cuda",
        "source": "demucs_tpu_torch/csrc/flash_mha.cu",
        "replaces": "demucs_tpu/ops/pallas/attention.py:90",
        "launches": b_launches["flash_mha"],
        "max_abs_err": max(r["err"] for r in k1_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library": "F.scaled_dot_product_attention in bf16",
        "shape": f"q,k,v ({MAIN_BATCH},{HEADS},2688,64) bfloat16",
        "launches_per_segment_batch": b_launches["flash_mha"] / b_batches,
        "path": "htdemucs-4s --bf16",
    })
    for kern, name, source, replaces, path_launches, batches, family, path in (
            ("K5", "dconv_sub_block_bf16", "dconv.cu", "demucs_tpu/ops/pallas/dconv.py:108",
             b_launches["dconv_sub_block"], b_batches, "htdemucs_4s", "htdemucs-4s --bf16"),
            ("K4", "gn_glu_scale_res_bf16", "dconv.cu", "demucs_tpu/ops/pallas/norms.py:62",
             bv3_launches["gn_glu_scale_res"], bv3_batches, "hdemucs_mmi",
             "hdemucs_mmi --bf16"),
            ("K6", "bilstm_recurrence_bf16", "bilstm.cu", "demucs_tpu/ops/pallas/lstm.py:76",
             bv3_launches["bilstm_recurrence"], bv3_batches, "hdemucs_mmi",
             "hdemucs_mmi --bf16"),
            ("K7", "int8_matmul_bf16w", "quant_matmul.cu",
             "demucs_tpu/ops/pallas/quant_matmul.py:46", bq_launches["int8_matmul"],
             bq_batches, "htdemucs_4s", "htdemucs-4s --bf16 --int8")):
        path_rows = [r for r in bf16_rows if r["kernel"] == kern and r["B"] == MAIN_BATCH
                     and (r["family"] == family or kern == "K7")]
        stream_rows = [r for r in bf16_rows if r["kernel"] == kern and r["B"] == 1]
        head = max((r for r in path_rows if r["family"] == family), key=lambda r: r["ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"demucs_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": path_launches,
            "max_abs_err": max(r["err"] for r in path_rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": {"K5": "none: no single PyTorch call computes the fused function",
                        "K4": "none: no single PyTorch call computes the fused function",
                        "K6": "nn.LSTM(H, H, bidirectional=True) in bf16, one layer (cuDNN)",
                        "K7": "F.linear of the weight widened to bf16 by PyTorch (f32 x)"}[kern],
            "shape": f"{family} {head['level']}: {head['shape']}",
            "f32_ms": head["f32_ms"],
            "launches_per_segment_batch": path_launches / batches,
            "path": path,
            **({"launches_v3": bqv3_launches["int8_matmul"]} if kern == "K7" else {}),
            **({"device_ms": head["device_ms"]} if kern == "K4" else {}),
            # B = 1, a --stream --bf16 call's shapes
            **({"stream_calls": stream_calls_entry(stream_rows)} if stream_rows else {}),
        })
    # the bag's and the streams' launches beside each kernel's: the dense
    # bag for the f32 forms, the --int8 bag for K7, the --bf16 bag for the
    # bf16 forms; per stream call of each streamed model
    for entry in kernels:
        name = entry["name"]
        base = name.removesuffix("_bf16")
        bag_run, batches = ((bbag_launches, bbag_batches) if name.endswith("_bf16") else
                            (qbag_launches, qbag_batches) if name == "int8_matmul" else
                            (bag_launches, bag_batches))
        if base in bag_run and not name.endswith("_bf16w"):
            entry["launches_bag"] = bag_run[base]
            entry["launches_bag_per_segment_batch"] = bag_run[base] / batches
        if not name.endswith(("_bf16", "_bf16w")):
            entry["launches_tools"] = tools_summary["launches"][name]
            entry["launches_acceptance"] = {
                label: rec["launches"][name] for label, rec in acceptance["gate"].items()
                if rec["launches"][name]}
            entry["launches_stream"] = {kind: st["launches"][name]
                                        for kind, st in streams.items()}
            entry["launches_serving"] = {
                kind: serving[kind]["concurrent"]["launches"][name]
                for kind in ("htdemucs_4s", "hdemucs_mmi", "bag")}
    # each kernel's launches per training step on every training path that
    # runs it (the f32 forms; the bf16 forms under --bf16-compute)
    train_paths = {"htdemucs_4s": (train_launches, n_steps),
                   "hdemucs_mmi": (v3_train_launches, v3_steps)}
    for label, rec in train_modes.items():
        if "--eval-every" not in label:
            steps = 4 if "--steps-per-call" in label else 2
            train_paths[label] = (rec["launches"], steps)
    for entry in kernels:
        name = entry["name"]
        base = name.removesuffix("_bf16")
        per_step = {}
        for label, (counts, steps) in train_paths.items():
            if "--bf16-compute" in label:
                # bf16 forms: K4-K6's have entries of their own, K2's and K3's not
                bf16 = name.endswith("_bf16") or name in ("flash_mha_fwd", "flash_mha_bwd")
                n = train_modes[label]["launches_by_dtype"].get(base, {}).get(
                    "bfloat16", 0) if bf16 else 0
            else:
                n = 0 if name.endswith("_bf16") else counts.get(name, 0)
            if n:
                per_step[label] = n / steps
        if per_step:
            entry["launches_training_per_step"] = per_step
    # each kernel's launches per rank in the multi-rank phase's runs
    multi_runs = {**multi["runs"], **{f"training {k}": v for k, v in multi["training"].items()}}
    for entry in kernels:
        per_rank = {label: [counts[entry["name"]] for counts in rec["launches_per_rank"]]
                    for label, rec in multi_runs.items()
                    if entry["name"] in rec["launches_per_rank"][0]
                    and rec["launches_per_rank"][0][entry["name"]]}
        if per_rank:
            entry["launches_multi_rank"] = per_rank
    # each kernel at a rank's shapes in those runs where they differ from
    # one card's: held against its twin at TOL in its phase, its slowest
    # call timed beside its bound
    for entry in kernels:
        shapes = multi_rank_shapes(entry["name"], rows, train_rows, lstm_rows, dconv_rows,
                                   int8_rows)
        if shapes:
            entry["multi_rank_shapes"] = shapes
    log(json.dumps({"multi_rank": multi}))
    log(json.dumps({"bag": bag_summary}))
    log(json.dumps({"bag_int8": qbag_summary}))
    log(json.dumps({"bag_fp8": fp8bag_summary}))
    log(json.dumps({"bag_bf16": bbag_summary}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"stream": streams}))
    log(json.dumps({"main_path_bf16": b_summary}))
    log(json.dumps({"main_path_v3_bf16": bv3_summary}))
    log(json.dumps({"main_path_bf16_int8": bq_summary}))
    log(json.dumps({"main_path_v3_bf16_int8": bqv3_summary}))
    log(json.dumps({"main_path_bf16_fp8": bfp8_summary}))
    log(json.dumps({"main_path_v3_bf16_fp8": bv3fp8_summary}))
    log(json.dumps({"bf16_long_track": bf16_long}))
    log(json.dumps({"main_path": summary}))
    log(json.dumps({"main_path_v3": v3_summary}))
    log(json.dumps({"main_path_int8": q_summary}))
    log(json.dumps({"main_path_v3_int8": qv3_summary}))
    log(json.dumps({"main_path_fp8": fp8_summary}))
    log(json.dumps({"host_path": host_summary}))
    log(json.dumps({"training": train_summary}))
    log(json.dumps({"training_v3": v3_train_summary}))
    log(json.dumps({"training_modes": train_modes}))
    log(json.dumps({"reference_6s": six_summary}))
    log(json.dumps({"native": native_summary}))
    log(json.dumps({"tools": tools_summary}))
    log(json.dumps({"acceptance": acceptance}))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

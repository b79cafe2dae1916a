"""Command-line entry point: separation of one WAV or of every WAV in a
directory, by one model or by the fine-tuned bag, offline or as a stream.

The port of the single-device paths of `demucs_tpu/cli.py`:

    python -m demucs_tpu_torch model.bin in.wav out/ [--device cuda|cpu]
    python -m demucs_tpu_torch model.bin tracks/ out/   # out/<track>/...
    python -m demucs_tpu_torch --ft-dir models/ in.wav out/
    python -m demucs_tpu_torch model.bin in.wav out/ --stream

The model family is chosen by the ggml file's magic: dmc4/dmc6 run
htdemucs 4s/6s (Demucs v4), dmc3 runs hdemucs_mmi (Demucs v3). `model`
may also be a checkpoint directory (`params.checkpoint_io`), whose family
is inferred from its tensors.
`--int8` (or `--fp8`) holds the large weights quantized on the device,
with per-output-channel scales (`params.quant`); int8 linears run the
kernel K7. `--bf16` alone casts every weight to bfloat16 and runs the
network in bf16 (the spectra, statistics and inverse STFT stay f32).
With `--int8` or `--fp8` it composes as the JAX CLI's does: the weights
are quantized from f32 and widened to bf16 (bf16(bf16(q) * bf16(scale)));
every dense weight stays f32, and so does the network. A directory's
tracks (its `.wav` files, sorted) share one global batch
(`Separator.separate_many`). `--pipeline-depth`, `--fused`,
`--fused-buckets` and `--transfer-int16` set the `ApplyOptions` of the
same names (`pipeline.py`).
`--ft-dir DIR` replaces `model` with the htdemucs_ft bag: the first file
of DIR (sorted) whose name holds `htdemucs_ft_{stem}`, for drums, bass,
other and vocals in that order, each model quantized or cast on its own
and built with the first file's config; stem i comes from model i
(`models.BagOfModels`). `--stream` separates in chunks of
`--stream-chunk-secs` (`streaming.StreamingSeparator`, `--batch`
segments a device call), with one model or the bag; as in the JAX CLI it
takes a single WAV, refuses `--fused` and `--transfer-int16`, applies
`--bf16` and reads neither `--int8` nor `--fp8`.
Output files are target_{i}_{name}.wav, in `outdir/<track stem>/` when
there is more than one track. The run goes to the GPU unless
`--device cpu` is given; without a GPU a CUDA run fails.

Several cards (the mesh path of the JAX CLI): where more than one card
is visible and `--no-mesh` is not given, the command spawns one rank per
card (`run_ranks`: `torch.multiprocessing`, the spawn start method, NCCL)
after building the kernels once, and the ranks separate over a (bag, dp,
tp) mesh (`parallel.ShardedSeparator`): the segment batches over dp,
the transformer's heads over `--tp` ranks, and with `--ft-dir` the bag's
models over 4 groups of ranks when the card count divides by 4 x tp.
Rank 0 writes the stems; a rank that fails makes the command exit
non-zero. `--fused` is a single-card path and forces `--no-mesh` (with a
note), as in the JAX CLI; `--stream` runs on one card. On one card (or
`--device cpu`) `--tp` is not read. A rank's body, `rank_main(rank,
world, args, init_method)`, also runs over gloo on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import audio
from . import config as C
from .models import build_bag, build_model
from .params.ggml import load_model_params
from .params import cast_state_dict
from .params.quant import fp8_compute_supported, quantize_fp8, quantize_int8
from .parallel import (ShardedSeparator, axis_group, axis_size, bag_share, free_port,
                       init_distributed, make_mesh, shard_state_dict)
from .pipeline import ApplyOptions, Separator
from .streaming import StreamingSeparator
from .utils.device import resolve_device
from .utils.progress import null_progress, print_progress

FT_STEMS = ("drums", "bass", "other", "vocals")


def _find_ft_models(model_dir: Path) -> list[Path]:
    """The four fine-tuned files, one per stem of FT_STEMS in that order:
    the first name (sorted) that holds `htdemucs_ft_{stem}`."""
    files = []
    for stem in FT_STEMS:
        matches = sorted(p for p in model_dir.iterdir() if f"htdemucs_ft_{stem}" in p.name)
        if not matches:
            raise FileNotFoundError(f"no htdemucs_ft_{stem} model in {model_dir}")
        files.append(matches[0])
    return files


def _load(args) -> tuple[object, list[dict]]:
    """(config, state dicts): the one model file, or the bag's four with
    the first file's config."""
    if args.ft_dir:
        loaded = [load_model_params(p) for p in _find_ft_models(Path(args.ft_dir))]
        return loaded[0][0], [sd for _, sd in loaded]
    cfg, state_dict = load_model_params(args.model)
    return cfg, [state_dict]


def _build(args, cfg, state_dicts: list[dict], device: torch.device,
           quant_dtype: torch.dtype = torch.float32, tp_group=None) -> torch.nn.Module:
    """The bag of `state_dicts` with --ft-dir, else its one model."""
    if args.ft_dir:
        return build_bag(cfg, state_dicts, device, quant_dtype, tp_group)
    return build_model(cfg, state_dicts[0], device, quant_dtype=quant_dtype, tp_group=tp_group)


def _build_separator(args, mesh=None, device: torch.device | None = None
                     ) -> tuple[Separator, tuple[str, ...]]:
    """The separator of the command line: on one device, or with `mesh`
    this rank's `ShardedSeparator` on `device`."""
    opts = ApplyOptions(batch_size=args.batch,
                        shift_offset=args.offset,
                        transfer_int16=args.transfer_int16,
                        fused_track=args.fused,
                        fused_buckets=args.fused_buckets,
                        pipeline_depth=args.pipeline_depth,
                        ).with_segment(args.segment_samples)
    device = device or resolve_device(args.device)
    cfg, state_dicts = _load(args)
    if args.int8 or args.fp8:
        if args.fp8 and not fp8_compute_supported(device):
            name = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
            print(f"warning: --fp8 on {name} has no native fp8 matmul: the fp8 "
                  "weights are widened at every call, which costs compute and saves "
                  "only memory; use --int8 instead", file=sys.stderr)
        # int8 wins when both are given, as in the JAX CLI; each model of a
        # bag is quantized on its own, so its scales stay its own
        quantize = quantize_int8 if args.int8 else quantize_fp8
        state_dicts = [quantize(sd) for sd in state_dicts]
    elif args.bf16:
        state_dicts = [cast_state_dict(sd, torch.bfloat16) for sd in state_dicts]
    quant_dtype = torch.bfloat16 if args.bf16 else torch.float32
    if mesh is None:
        model = _build(args, cfg, state_dicts, device, quant_dtype)
        return Separator(model, cfg.num_sources, opts, device), cfg.sources
    tp_group = axis_group(mesh, "tp")
    if args.ft_dir and axis_size(mesh, "bag") > 1:
        # this rank's bag group builds only its share of the models
        models = [build_model(cfg, shard_state_dict(state_dicts[i], mesh), device,
                              quant_dtype, tp_group=tp_group)
                  for i in bag_share(mesh, len(state_dicts))]
        return ShardedSeparator(models, cfg.num_sources, mesh, opts, bag_stacked=True,
                                device=device), cfg.sources
    state_dicts = [shard_state_dict(sd, mesh) for sd in state_dicts]
    model = _build(args, cfg, state_dicts, device, quant_dtype, tp_group)
    return ShardedSeparator(model, cfg.num_sources, mesh, opts, device=device), cfg.sources


def _run_stream(args) -> int:
    """Chunked stateful separation (`streaming.StreamingSeparator`) of one
    WAV, pushed `--stream-chunk-secs` at a time. Its stems match the
    offline path run without the shift trick, with causal normalization
    statistics. As the JAX CLI's stream, it applies --bf16 and nothing
    else: --int8 and --fp8 are not read."""
    try:
        in_path = Path(args.input)
        if in_path.is_dir():
            raise ValueError("--stream takes a single WAV, not a dir")
        track = audio.load_track(in_path)
        t0 = time.monotonic()
        device = resolve_device(args.device)
        cfg, state_dicts = _load(args)
        if args.bf16:
            state_dicts = [cast_state_dict(sd, torch.bfloat16) for sd in state_dicts]
        stream = StreamingSeparator(_build(args, cfg, state_dicts, device), cfg.num_sources,
                                    segment_samples=args.segment_samples or C.SEGMENT_SAMPLES,
                                    max_batch=args.batch, device=device)
        print(f"model loaded on {device} in {time.monotonic() - t0:.2f} s", file=sys.stderr)
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    N = track.shape[-1]
    chunk = max(1, int(args.stream_chunk_secs * C.SAMPLE_RATE))
    t0 = time.monotonic()
    outs, emitted = [], 0
    for pos in range(0, N, chunk):
        out = stream.push(track[:, pos:pos + chunk])
        if out.shape[-1]:
            outs.append(out)
            emitted += out.shape[-1]
            print(f"\rstreamed {emitted}/{N} samples "
                  f"({emitted / C.SAMPLE_RATE:.1f} s)", end="", file=sys.stderr)
    outs.append(stream.flush())
    print("", file=sys.stderr)
    dt = time.monotonic() - t0
    stems = np.concatenate([o for o in outs if o.shape[-1]], -1)
    print(f"streamed {N / C.SAMPLE_RATE:.1f} s of audio in {dt:.1f} s "
          f"({N / C.SAMPLE_RATE / dt:.2f}x realtime)", file=sys.stderr)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(cfg.sources):
        path = outdir / f"target_{i}_{name}.wav"
        audio.write_wav(path, np.asarray(stems[i]), pcm16=args.pcm16)
        print(f"wrote {path}", file=sys.stderr)
    return 0


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="demucs-tpu-torch",
        description="Demucs v4/v3 music source separation on PyTorch and CUDA")
    ap.add_argument("model", nargs="?",
                    help="ggml weight file (dmc4/dmc6: v4, dmc3: v3) or "
                         "checkpoint directory")
    ap.add_argument("input", help="input WAV (44.1 kHz), or a directory of them")
    ap.add_argument("outdir", help="output directory for stem WAVs")
    ap.add_argument("--ft-dir", help="directory with the 4 htdemucs_ft_* files "
                                     "(the fine-tuned bag; replaces `model`)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: cuda)")
    ap.add_argument("--batch", type=int, default=8,
                    help="segments per device call")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (several cards)")
    ap.add_argument("--offset", type=int, default=None,
                    help="pin the shift-trick offset (1337 = reference "
                         "SDR setup)")
    ap.add_argument("--pcm16", action="store_true",
                    help="write 16-bit PCM instead of float32 WAV")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 quantization (per-channel scales)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 weights/compute (DSP stays f32)")
    ap.add_argument("--fp8", action="store_true",
                    help="weight-only float8 e4m3 quantization")
    ap.add_argument("--no-mesh", action="store_true",
                    help="one card even if more are visible")
    ap.add_argument("--fused", action="store_true",
                    help="fused whole-track pass: split, model and overlap-add "
                         "on the device, one upload and one download per track "
                         "(one card)")
    ap.add_argument("--fused-buckets", choices=("exact", "geo"), default="exact",
                    help="track-length buckets of --fused's plans (geo: "
                         "log-many plans over all lengths)")
    ap.add_argument("--transfer-int16", action="store_true",
                    help="int16 device-to-host stem transfers (half the bytes; "
                         "a step of 8/32767 of the track's std)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="device calls in flight (the next batch is launched "
                         "before the last one is fetched; 1 = serial)")
    ap.add_argument("--stream", action="store_true",
                    help="chunked stateful separation: stems are finalized as "
                         "audio arrives (no shift trick, causal statistics)")
    ap.add_argument("--stream-chunk-secs", type=float, default=1.0,
                    help="push granularity for --stream")
    ap.add_argument("--segment-samples", type=int, default=None,
                    help=argparse.SUPPRESS)  # testing: shrink the 7.8 s segment
    args = ap.parse_args(argv)

    if bool(args.model) == bool(args.ft_dir):
        ap.error("provide exactly one of `model` or --ft-dir")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.stream and (args.fused or args.transfer_int16):
        ap.error("--stream has its own device path; drop --fused/--transfer-int16")
    return args


def _mesh_world(args) -> int:
    """The ranks the command runs: one per visible card where more than one
    is visible and neither --no-mesh nor --device cpu is given, else 1.
    --fused forces --no-mesh, as in the JAX CLI."""
    if args.no_mesh or args.device != "cuda" or torch.cuda.device_count() < 2:
        return 1
    if args.fused:
        print("note: --fused is a single-device path; forcing --no-mesh", file=sys.stderr)
        return 1
    return torch.cuda.device_count()


def main(argv=None) -> int:
    args = _parse(argv)
    if args.stream:
        return _run_stream(args)
    world = _mesh_world(args)
    if world > 1:
        return run_ranks(args, world)
    return _separate(args)


def run_ranks(args, world: int, backend: str | None = None) -> int:
    """Separate as `world` ranks, one process each (`torch.multiprocessing`,
    spawn), rank r on card r % card count, joined at a free port of this
    host with `backend` (default: NCCL on cuda, gloo on the CPU). The
    kernels are built here first, so the ranks do not build them again.
    Returns 0, or 1 if any rank failed (the others are then stopped)."""
    if args.device == "cuda":
        from .ops.cuda import build, dconv, flash_attention, lstm, quant_matmul

        build.build(flash_attention.SOURCES + lstm.SOURCES + dconv.SOURCES
                    + quant_matmul.SOURCES)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ranks = torch.multiprocessing.start_processes(
        _rank_entry, args=(world, args, init_method, backend), nprocs=world, join=False,
        start_method="spawn")
    try:
        while not ranks.join():
            pass
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        print(f"error: rank {e.error_index} failed: {e}", file=sys.stderr)
        return 1
    return 0


def _rank_entry(rank: int, world: int, args, init_method: str, backend: str | None) -> None:
    rc = rank_main(rank, world, args, init_method, backend)
    if rc:
        sys.exit(rc)


def rank_main(rank: int, world: int, args, init_method: str,
              backend: str | None = None) -> int:
    """One rank's separation: join the group, build the (bag, dp, tp) mesh
    (bag 4 with --ft-dir where world divides by 4 x tp, else 1), separate
    every track as a `ShardedSeparator`; rank 0 writes the stems."""
    device = init_distributed(rank, world, init_method, args.device, backend)
    try:
        try:
            bag = 4 if args.ft_dir and world % (4 * args.tp) == 0 else 1
            mesh = make_mesh(tp=args.tp, bag=bag, device_type=device.type)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        return _separate(args, mesh, device)
    finally:
        dist.destroy_process_group()


def _separate(args, mesh=None, device: torch.device | None = None) -> int:
    """Separate the command line's tracks and write their stems: on one
    device, or with `mesh` as this rank (rank 0 logs and writes)."""
    lead = mesh is None or dist.get_rank() == 0
    try:
        in_path = Path(args.input)
        if in_path.is_dir():  # batch mode: every wav, one global batch
            files = sorted(p for p in in_path.iterdir() if p.suffix.lower() == ".wav")
            if not files:
                raise FileNotFoundError(f"no .wav files in {in_path}")
        else:
            files = [in_path]
        tracks = [audio.load_track(p) for p in files]
        total_s = sum(t.shape[1] for t in tracks) / 44100.0
        if lead:
            print(f"input: {len(files)} track(s), {total_s:.1f} s total", file=sys.stderr)
        t0 = time.monotonic()
        sep, sources = _build_separator(args, mesh, device)
        if lead:
            ranks = "" if mesh is None else f" x {dist.get_world_size()} ranks {mesh}"
            print(f"model loaded on {sep.device}{ranks} in {time.monotonic() - t0:.2f} s",
                  file=sys.stderr)
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    progress = print_progress if lead else null_progress
    t0 = time.monotonic()
    if len(tracks) == 1:
        outs = [sep(tracks[0], progress=progress)]
    else:
        outs = sep.separate_many(tracks, progress=progress)
    dt = time.monotonic() - t0
    if not lead:
        return 0
    print(f"separated {total_s:.1f} s of audio in {dt:.1f} s "
          f"({total_s / dt:.2f}x realtime)", file=sys.stderr)

    outdir = Path(args.outdir)
    for f, out in zip(files, outs):
        d = outdir if len(files) == 1 else outdir / f.stem
        d.mkdir(parents=True, exist_ok=True)
        for i, name in enumerate(sources):
            path = d / f"target_{i}_{name}.wav"
            audio.write_wav(path, np.asarray(out[i]), pcm16=args.pcm16)
            print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

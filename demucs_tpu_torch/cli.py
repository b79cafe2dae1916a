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
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import audio
from . import config as C
from .models import build_bag, build_model
from .params.ggml import load_model_params
from .params import cast_state_dict
from .params.quant import fp8_compute_supported, quantize_fp8, quantize_int8
from .pipeline import ApplyOptions, Separator
from .streaming import StreamingSeparator
from .utils.device import resolve_device
from .utils.progress import print_progress

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
           quant_dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The bag of `state_dicts` with --ft-dir, else its one model."""
    if args.ft_dir:
        return build_bag(cfg, state_dicts, device, quant_dtype)
    return build_model(cfg, state_dicts[0], device, quant_dtype=quant_dtype)


def _build_separator(args) -> tuple[Separator, tuple[str, ...]]:
    opts = ApplyOptions(batch_size=args.batch,
                        shift_offset=args.offset,
                        transfer_int16=args.transfer_int16,
                        fused_track=args.fused,
                        fused_buckets=args.fused_buckets,
                        pipeline_depth=args.pipeline_depth,
                        ).with_segment(args.segment_samples)
    device = resolve_device(args.device)
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
    model = _build(args, cfg, state_dicts, device,
                   torch.bfloat16 if args.bf16 else torch.float32)
    return Separator(model, cfg.num_sources, opts, device), cfg.sources


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


def main(argv=None) -> int:
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
    ap.add_argument("--fused", action="store_true",
                    help="fused whole-track pass: split, model and overlap-add "
                         "on the device, one upload and one download per track")
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
    if args.stream:
        if args.fused or args.transfer_int16:
            ap.error("--stream has its own device path; drop --fused/--transfer-int16")
        return _run_stream(args)

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
        print(f"input: {len(files)} track(s), {total_s:.1f} s total", file=sys.stderr)
        t0 = time.monotonic()
        sep, sources = _build_separator(args)
        print(f"model loaded on {sep.device} in {time.monotonic() - t0:.2f} s",
              file=sys.stderr)
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    if len(tracks) == 1:
        outs = [sep(tracks[0], progress=print_progress)]
    else:
        outs = sep.separate_many(tracks, progress=print_progress)
    dt = time.monotonic() - t0
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

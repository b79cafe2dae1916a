"""Command-line driver: single-model separation of one WAV.

The port of the single-model path of `demucs_tpu/cli.py`:

    python -m demucs_tpu_torch model.bin in.wav out/ [--device cuda|cpu]

The model family is chosen by the ggml file's magic: dmc4/dmc6 run
htdemucs 4s/6s (Demucs v4), dmc3 runs hdemucs_mmi (Demucs v3).
Output files are target_{i}_{name}.wav. The run goes to the GPU unless
`--device cpu` is given; without a GPU a CUDA run fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from . import audio
from .models import build_model
from .params.ggml import load_model_params
from .pipeline import ApplyOptions, Separator
from .utils.device import resolve_device
from .utils.progress import print_progress


def _build_separator(args) -> tuple[Separator, tuple[str, ...]]:
    opts = ApplyOptions(batch_size=args.batch,
                        shift_offset=args.offset,
                        ).with_segment(args.segment_samples)
    device = resolve_device(args.device)
    cfg, state_dict = load_model_params(args.model)
    model = build_model(cfg, state_dict, device)
    return Separator(model, cfg.num_sources, opts, device), cfg.sources


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="demucs-tpu-torch",
        description="Demucs v4/v3 music source separation on PyTorch and CUDA")
    ap.add_argument("model", help="ggml weight file (dmc4/dmc6: v4, dmc3: v3)")
    ap.add_argument("input", help="input WAV (44.1 kHz)")
    ap.add_argument("outdir", help="output directory for stem WAVs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: cuda)")
    ap.add_argument("--batch", type=int, default=8,
                    help="segments per device call")
    ap.add_argument("--offset", type=int, default=None,
                    help="pin the shift-trick offset (1337 = reference "
                         "SDR setup)")
    ap.add_argument("--pcm16", action="store_true",
                    help="write 16-bit PCM instead of float32 WAV")
    ap.add_argument("--segment-samples", type=int, default=None,
                    help=argparse.SUPPRESS)  # testing: shrink the 7.8 s segment
    args = ap.parse_args(argv)

    try:
        in_path = Path(args.input)
        if in_path.is_dir():
            raise ValueError(f"{in_path}: a directory of tracks is not "
                             "supported by demucs_tpu_torch yet; pass one WAV")
        track = audio.load_track(in_path)
        total_s = track.shape[1] / 44100.0
        print(f"input: {in_path}, {total_s:.1f} s", file=sys.stderr)
        t0 = time.monotonic()
        sep, sources = _build_separator(args)
        print(f"model loaded on {sep.device} in {time.monotonic() - t0:.2f} s",
              file=sys.stderr)
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    out = sep(track, progress=print_progress)
    dt = time.monotonic() - t0
    print(f"separated {total_s:.1f} s of audio in {dt:.1f} s "
          f"({total_s / dt:.2f}x realtime)", file=sys.stderr)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(sources):
        path = outdir / f"target_{i}_{name}.wav"
        audio.write_wav(path, np.asarray(out[i]), pcm16=args.pcm16)
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

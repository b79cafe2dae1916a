"""SDR acceptance gate: the port's pipeline against the torch oracle.

The port of `demucs_tpu/tools/sdr_acceptance.py`, which automates the
reference's tier-4 methodology (SURVEY.md §4: run both implementations
on a track with the shift pinned to 1337, SDR each against ground-truth
stems, require <= 0.1 dB per-stem delta, .github/SDR_scores.md). It runs
the port's CLI (`cli.main --no-mesh`, the port's models and kernels) and
`tools/torch_inference.py` (the independent oracle models, in plain
torch) on the same files, on `--device`. With MUSDB18-HQ ground truth
pass `--ref-dir`; without it the tool gates on the cross-implementation
SDR (the port's estimate scored against the oracle's: a lower bound on
agreement, >= 30 dB to pass; >= ~40 dB means numerically
interchangeable). NaN fails either gate.

The JSON report (the last line of stdout) has the JAX tool's keys, one
renamed: per stem `cross_impl_sdr_db` and, with `--ref-dir`,
`port_sdr_db` (the JAX tool's `jax_sdr_db`: here the port's estimate
against the ground truth), `torch_sdr_db` and `delta_db`; then `pass`.
Exit code 0 on pass, 2 on fail, 1 if either run failed. The stems stay
in `--workdir` when it is given (`port/`, `torch/`); otherwise they go
to a temporary directory that is removed.

Usage:
    python -m demucs_tpu_torch.tools.sdr_acceptance MODEL.bin TRACK.wav \
        [--ref-dir musdb_track_dir] [--tolerance-db 0.1] [--workdir DIR] \
        [--device cuda|cpu]
    python -m demucs_tpu_torch.tools.sdr_acceptance --ft-dir MODELS/ TRACK.wav
        # BagOfModels gate (the reference's best SDR row,
        # .github/SDR_scores.md:48-61): the port's bag vs the torch
        # oracle bag, gated per stem
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import tempfile
from pathlib import Path

from .. import audio
from ..cli import main as cli_main
from ..config import HTDEMUCS_4S, HTDEMUCS_6S
from ..params.ggml import GGML_MAGICS
from .evaluate_sdr import _find_stem, median_sdr
from .torch_inference import main as torch_main

CROSS_GATE_DB = 30.0  # cross-implementation SDR needed without --ref-dir


def stem_names(model: str | None) -> tuple[str, ...]:
    """The stems of a ggml file, from its 4-byte magic alone (no weight
    parse); the ft bag (`model` None) is always the 4-source family."""
    if model is None:
        return HTDEMUCS_4S.sources
    with open(model, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
    return (HTDEMUCS_6S if GGML_MAGICS.get(magic) == "htdemucs_6s" else HTDEMUCS_4S).sources


def _num(x: float) -> float | None:
    """NaN (silent / <1 s windows) must not leak into JSON."""
    return None if (x != x) else round(x, 3)


def gate(port_dir: Path, torch_dir: Path, sources, ref_dir: str | None,
         tolerance_db: float) -> dict:
    """The report of the stems in `port_dir` against those in `torch_dir`
    (and each against the ground truth in `ref_dir`, if given)."""
    report = {}
    ok = True
    for i, stem in enumerate(sources):
        px, _ = audio.read_wav(port_dir / f"target_{i}_{stem}.wav")
        tx, _ = audio.read_wav(torch_dir / f"target_{i}_{stem}.wav")
        cross = median_sdr(tx, px)   # agreement between implementations
        entry = {"cross_impl_sdr_db": _num(cross)}
        if ref_dir:
            try:
                ref, _ = audio.read_wav(_find_stem(Path(ref_dir), stem))
            except FileNotFoundError:
                print(f"warning: no {stem} ground truth in {ref_dir}",
                      file=sys.stderr)
                ref = None
            if ref is not None:
                s_port = median_sdr(ref, px)
                s_torch = median_sdr(ref, tx)
                delta = abs(s_port - s_torch)
                entry.update({"port_sdr_db": _num(s_port),
                              "torch_sdr_db": _num(s_torch),
                              "delta_db": _num(delta)})
                ok &= delta <= tolerance_db  # NaN compares False -> fail
        else:
            # no ground truth: gate on cross-implementation agreement
            ok &= (cross == cross) and cross >= CROSS_GATE_DB
        report[stem] = entry
    report["pass"] = bool(ok)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SDR acceptance gate")
    ap.add_argument("model", nargs="?",
                    help="ggml weight file (or use --ft-dir)")
    ap.add_argument("input")
    ap.add_argument("--ft-dir", default=None,
                    help="directory with the 4 htdemucs_ft_* files: "
                         "gate the BagOfModels ensemble (the port's bag vs "
                         "the torch oracle bag, per stem)")
    ap.add_argument("--ref-dir", default=None,
                    help="ground-truth stem dir (MUSDB layout)")
    ap.add_argument("--tolerance-db", type=float, default=0.1)
    ap.add_argument("--workdir", default=None,
                    help="keep the stems here (default: a temporary directory, removed)")
    ap.add_argument("--segment-samples", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of both runs (default cuda; a CUDA request "
                         "without a GPU raises)")
    args = ap.parse_args(argv)
    if bool(args.model) == bool(args.ft_dir):
        ap.error("provide exactly one of `model` or --ft-dir")

    with tempfile.TemporaryDirectory(prefix="sdr_accept_") as tmp:
        work = Path(args.workdir or tmp)
        port_dir, torch_dir = work / "port", work / "torch"
        sel = [args.model] if args.model else ["--ft-dir", args.ft_dir]
        common = ["--offset", "1337", "--device", args.device]
        if args.segment_samples:
            common += ["--segment-samples", str(args.segment_samples)]
        if cli_main(sel + [args.input, str(port_dir), "--no-mesh"] + common) != 0:
            return 1
        if torch_main(sel + [args.input, str(torch_dir)] + common) != 0:
            return 1
        report = gate(port_dir, torch_dir, stem_names(args.model), args.ref_dir,
                      args.tolerance_db)
    print(json.dumps(report))
    return 0 if report["pass"] else 2


if __name__ == "__main__":
    sys.exit(main())

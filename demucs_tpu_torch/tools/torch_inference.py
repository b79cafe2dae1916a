"""Ground-truth PyTorch inference from a ggml weight file.

The port of `demucs_tpu/tools/torch_inference.py` (counterpart of the
reference's scripts/demucs_pytorch_inference.py:50-72): runs the torch
oracle models (`tools/torch_ref.py`, `tools/torch_ref_v3.py`) as the
model of the port's `pipeline.Separator`, through the same normalize /
shift / overlap-add path as the port's CLI, and writes
target_{i}_{stem}.wav for SDR comparison. Because the CLI and this tool
share the Separator, any difference between their stems is the models'
numerics.

The oracle runs inside `utils/device.f32_precision()`: the port's
models turn TF32 off in their own forward, the oracle's plain torch
modules do not, and cuDNN would otherwise run its convolutions in TF32
on the GPU.

Usage:
    python -m demucs_tpu_torch.tools.torch_inference MODEL.bin IN.wav OUT_DIR \
        [--offset 1337] [--segment-samples N] [--device cuda|cpu]
    python -m demucs_tpu_torch.tools.torch_inference --ft-dir MODELS/ IN.wav OUT_DIR
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import audio
from ..config import HDemucsV3Config
from ..params.ggml import load_model_params
from ..pipeline import ApplyOptions, Separator
from ..utils.device import f32_precision
from ..utils.progress import print_progress


class F32Oracle(nn.Module):
    """An oracle model whose forward runs with TF32 off."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with f32_precision():
            return self.model(mix)


def build_torch_model(cfg, state_dict: dict[str, torch.Tensor]) -> nn.Module:
    """The oracle of `cfg`'s family with `state_dict` loaded strictly."""
    if isinstance(cfg, HDemucsV3Config):
        from .torch_ref_v3 import HDemucsV3Ref
        model = HDemucsV3Ref(cfg)
    else:
        from .torch_ref import HTDemucsRef
        model = HTDemucsRef(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _torch_separator(model_path, opts: ApplyOptions, device: str
                     ) -> tuple[Separator, tuple[str, ...]]:
    cfg, state_dict = load_model_params(model_path)
    model = F32Oracle(build_torch_model(cfg, state_dict))
    return Separator(model, cfg.num_sources, opts, device), cfg.sources


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="torch oracle inference")
    ap.add_argument("model", nargs="?",
                    help="ggml weight file (or use --ft-dir)")
    ap.add_argument("input")
    ap.add_argument("outdir")
    ap.add_argument("--ft-dir", help="directory with 4 htdemucs_ft_* "
                                     "files (BagOfModels oracle: stem i "
                                     "from model i, the ft convention — "
                                     "reference cli-apps/demucs_ft.cpp)")
    ap.add_argument("--offset", type=int, default=1337)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--segment-samples", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the oracle (default cuda; a CUDA request "
                         "without a GPU raises)")
    args = ap.parse_args(argv)
    if bool(args.model) == bool(args.ft_dir):
        ap.error("provide exactly one of `model` or --ft-dir")

    opts = ApplyOptions(batch_size=args.batch,
                        shift_offset=args.offset).with_segment(
                            args.segment_samples)
    track = audio.load_track(args.input)

    if args.ft_dir:
        from ..cli import _find_ft_models

        paths = _find_ft_models(Path(args.ft_dir))
        stems, sources = [], None
        for i, p in enumerate(paths):
            sep, sources = _torch_separator(p, opts, args.device)
            out = sep(track, progress=print_progress)
            stems.append(np.asarray(out[i]))  # ft: stem i from model i
            print(f"oracle model {i + 1}/4 done", file=sys.stderr)
        out = np.stack(stems)
    else:
        sep, sources = _torch_separator(args.model, opts, args.device)
        out = sep(track, progress=print_progress)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(sources):
        audio.write_wav(outdir / f"target_{i}_{name}.wav", np.asarray(out[i]))
        print(f"wrote target_{i}_{name}.wav", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Convert a PyTorch Demucs checkpoint to the ggml weight format.

The port of `demucs_tpu/tools/convert_pth_to_ggml.py` (counterpart of
the reference's scripts/convert-pth-to-ggml.py:110-140, minus the hub
download): point it at a local checkpoint file. Accepts a full
`nn.Module`, the demucs checkpoint wrappers (`{'state': ...}`,
`{'models': [...]}`) or a raw state dict. Tensors are squeezed and
stored fp16, as the reference's writer stores them; the ggml file is the
one both packages read.

With `--orbax` it writes the port's checkpoint directory instead
(`params/checkpoint_io.py`: one `state_dict.pt` of fp16 tensors at the
schema's full shapes, PyTorch names): the port's counterpart of the JAX
tool's Orbax directory, taken by the inference CLI as its model.

Usage:
    python -m demucs_tpu_torch.tools.convert_pth_to_ggml CKPT OUT.bin \
        --kind {htdemucs_4s,htdemucs_6s,hdemucs_mmi} [--orbax]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..params.checkpoint_io import save_checkpoint
from ..params.ggml import MAGIC_BY_NAME, write_ggml
from ..params.tree import from_state_dict
from . import family


def extract_state_dict(obj) -> dict:
    """Unwrap the common demucs checkpoint containers."""
    if hasattr(obj, "state_dict"):  # full nn.Module
        obj = obj.state_dict()
    if isinstance(obj, dict):
        if "state" in obj and isinstance(obj["state"], dict):
            return obj["state"]
        if "models" in obj and isinstance(obj["models"], (list, tuple)):
            return extract_state_dict(obj["models"][0])
        return obj
    raise ValueError(f"unsupported checkpoint type {type(obj)!r}")


def to_numpy_fp16(sd: dict) -> dict[str, np.ndarray]:
    out = {}
    for name, t in sd.items():
        a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
        out[name] = np.ascontiguousarray(np.squeeze(a)).astype(np.float16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="PyTorch Demucs checkpoint -> ggml")
    ap.add_argument("checkpoint", help=".pth/.th file (torch.load-able)")
    ap.add_argument("output", help="output ggml file (or checkpoint "
                                   "directory with --orbax)")
    ap.add_argument("--kind", required=True, choices=sorted(MAGIC_BY_NAME),
                    help="model family (sets the file magic)")
    ap.add_argument("--orbax", action="store_true",
                    help="write the port's checkpoint directory (state_dict.pt: "
                         "full-shape fp16 tensors, PyTorch names), its "
                         "counterpart of the JAX tool's Orbax directory, "
                         "instead of ggml")
    args = ap.parse_args(argv)

    obj = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    sd = to_numpy_fp16(extract_state_dict(obj))
    if args.orbax:
        # the directory keeps the schema's full shapes: un-squeeze through
        # the same shape contract the ggml reader applies on load
        _, schema = family("hdemucs_v3" if args.kind == "hdemucs_mmi" else args.kind)
        full = from_state_dict(sd, schema)
        save_checkpoint(args.output, {k: v.half() for k, v in full.items()})
    else:
        write_ggml(args.output, args.kind, sd)
    total = sum(v.nbytes for v in sd.values())
    print(f"wrote {len(sd)} tensors ({total / 1e6:.2f} MB fp16) -> "
          f"{args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

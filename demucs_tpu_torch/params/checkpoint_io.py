"""Checkpoint directories of weights: the port's counterpart of
`demucs_tpu/params/orbax_io.py`.

A checkpoint is a directory that holds the flat state dict (the schema's
dotted PyTorch names, the names of the ggml records) as one `torch.save`
file, `state_dict.pt`, with each tensor's dtype kept. `load_model_params`
(`params/ggml.py`) takes such a directory in place of a ggml file and
finds the model's family from the names and shapes (`infer_kind`), as the
JAX package does for its Orbax directories; so the inference CLI and the
trainer's `--init-from` take one.

The JAX package writes its directories with Orbax, which is not on the
GPU machine and which the port does not import: an Orbax directory is not
read here (the ggml file is the format both packages share).
"""

from __future__ import annotations

from pathlib import Path

import torch

FILE = "state_dict.pt"


def save_checkpoint(path: str | Path, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a flat state dict as a checkpoint directory (made if needed);
    the tensors are saved from the CPU, detached."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().to("cpu") for k, v in state_dict.items()}, path / FILE)


def load_flat(path: str | Path) -> dict[str, torch.Tensor]:
    """The flat state dict of a checkpoint directory, on the CPU."""
    path = Path(path)
    if not (path / FILE).is_file():
        raise ValueError(f"{path}: not a demucs_tpu_torch checkpoint directory (no {FILE}; "
                         "Orbax directories of the JAX package are not read)")
    return torch.load(path / FILE, map_location="cpu", weights_only=True)


def load_checkpoint(path: str | Path, dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """`load_flat`, with the floating-point tensors cast to `dtype` if it
    is given (torch.bfloat16 for the bf16 network)."""
    flat = load_flat(path)
    if dtype is None:
        return flat
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in flat.items()}


def infer_kind(flat: dict) -> str:
    """The model kind from the state dict (a directory carries no ggml
    magic): v3 has no crosstransformer; 4s and 6s differ in the last freq
    decoder's CaC output width (num_sources * 4)."""
    if not any(k.startswith("crosstransformer.") for k in flat):
        return "hdemucs_v3"
    key = "decoder.3.conv_tr.weight"
    if key not in flat:
        raise ValueError(f"unrecognized checkpoint: has a crosstransformer but no {key} "
                         "(not a stock htdemucs 4s/6s tree)")
    out_ch = flat[key].shape[1]
    kinds = {16: "htdemucs_4s", 24: "htdemucs_6s"}
    if out_ch not in kinds:
        raise ValueError(f"unrecognized checkpoint: {key} has {out_ch} output channels; "
                         "expected 16 (htdemucs-4s) or 24 (htdemucs-6s)")
    return kinds[out_ch]

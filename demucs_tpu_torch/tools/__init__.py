"""Command-line tools of the port: the trainer (`train_cli`), the server
(`serve`), the evaluation (`evaluate_sdr`), the measuring tools
(`memory_report`, `profile_hlo`, `bench_bag`, `bench_sweep`,
`bench_train`, `bench_serving`), the checkpoint converter
(`convert_pth_to_ggml`), and the acceptance gate (`sdr_acceptance`) with
its torch oracle models (`torch_ref`, `torch_ref_v3`, run on a track by
`torch_inference`).

The measuring tools share what is below: the families by name, a model
of random weights built as the CLI builds it for `--bf16`, `--int8` and
`--fp8`, and the card's name and power limit to print beside a number.
"""

from __future__ import annotations

import subprocess

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def family(name: str):
    """(config, schema) of "htdemucs_4s", "htdemucs_6s" or "hdemucs_v3"."""
    from .. import params as P
    from ..config import HDEMUCS_V3, HTDEMUCS_4S, HTDEMUCS_6S

    cfg = {"htdemucs_4s": HTDEMUCS_4S, "htdemucs_6s": HTDEMUCS_6S,
           "hdemucs_v3": HDEMUCS_V3}[name]
    schema = P.hdemucs_v3_schema(cfg) if name == "hdemucs_v3" else P.htdemucs_schema(cfg)
    return cfg, schema


def state_dict(name: str, dtype: str = "f32", quant: str = "none",
               seed: int = 0) -> tuple[dict, torch.dtype]:
    """(state dict, the dtype its quantized weights widen to) of family
    `name` with random weights from `seed`, as `cli.py` prepares it:
    `dtype` "bf16" alone casts every floating entry (`--bf16`); `quant`
    "int8" or "fp8" quantizes the f32 weights and keeps the network f32,
    the weights widening to bf16 with `dtype` "bf16" (`--bf16 --int8`)."""
    from .. import params as P

    _, schema = family(name)
    sd = P.from_state_dict(P.init_flat(schema, seed=seed), schema)
    if quant != "none":
        quantize = {"int8": P.quantize_int8, "fp8": P.quantize_fp8}[quant]
        return quantize(sd), DTYPES[dtype]
    if dtype == "bf16":
        sd = P.cast_state_dict(sd, torch.bfloat16)
    return sd, torch.float32


def segment_model(name: str, dtype: str = "f32", quant: str = "none",
                  device: str | torch.device = "cuda", seed: int = 0) -> torch.nn.Module:
    """The inference model of `state_dict(name, dtype, quant, seed)` on
    `device`: mix (B, 2, L) f32 -> (B, S, 2, L)."""
    from ..models import build_model

    sd, quant_dtype = state_dict(name, dtype, quant, seed)
    return build_model(family(name)[0], sd, device, quant_dtype=quant_dtype)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (its name
    alone where nvidia-smi is missing); "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             check=True, capture_output=True, text=True, timeout=60).stdout
        return out.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)

"""Weight-only quantization of a state dict (int8, float8 e4m3).

The port of `demucs_tpu/params/quant.py`. The JAX package turns a leaf of
its parameter pytree into {"q": ..., "scale": ...}; here a state-dict
entry `name` becomes the two entries `name.q` and `name.scale`, the same
dotted paths the JAX tree flattens to. `build_model` holds each such pair
in a `ops.quant.QuantizedWeight` in place of the dense parameter.

Which entries: those `should_quantize` accepts, the large matmul and
conv kernels. Norm affine parameters, biases, LayerScales, embeddings and
the LSTM's weights stay dense (the JAX package keeps norms and gate
biases in f32 for its 0.1 dB SDR budget). Scales are symmetric and per
output channel (dim 0), kept with the weight's rank: scale (out, 1, ...).

`dequantize_tree` / `quantized_model_fn` have no counterpart: the models
widen a quantized weight on the device where it is used
(`ops.quant.dense`), or hand an int8 one straight to the kernel K7.
"""

from __future__ import annotations

import re

import torch

# leaves worth quantizing: big matmul/conv kernels
_QUANT_SUFFIXES = ("weight",)
_SKIP_SUBSTRINGS = ("norm", "embedding", "lstm", "bias")
_MIN_SIZE = 4096  # don't bother with tiny tensors
E4M3_MAX = 448.0


def should_quantize(name: str, w: torch.Tensor) -> bool:
    """Whether state-dict entry `name` is quantized: a weight of rank >= 2
    and at least `_MIN_SIZE` elements that is no norm, embedding, LSTM
    or bias tensor."""
    if w.ndim < 2 or w.numel() < _MIN_SIZE:
        return False
    if not name.endswith(_QUANT_SUFFIXES):
        return False
    return not any(s in name.lower() for s in _SKIP_SUBSTRINGS)


def _channel_amax(w: torch.Tensor) -> torch.Tensor:
    return w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)


def _quantize(state_dict: dict[str, torch.Tensor], quantize_one) -> dict[str, torch.Tensor]:
    out = {}
    for name, w in state_dict.items():
        if should_quantize(name, w):
            q, scale = quantize_one(w.float())
            out[f"{name}.q"], out[f"{name}.scale"] = q, scale
        else:
            out[name] = w
    return out


def quantize_int8(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Dense state dict -> one whose quantized entries are int8 `q` and f32
    `scale`: s = max|w| / 127 per output channel, q = round(w / s) (half
    to even, as numpy rounds) clipped to [-127, 127]."""

    def one(w):
        scale = torch.clamp(_channel_amax(w) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return q, scale

    return _quantize(state_dict, one)


def quantize_fp8(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Dense state dict -> float8 e4m3fn `q` and f32 `scale`: the scale maps
    each output channel's max|w| to the format's 448, so nothing clips."""

    def one(w):
        scale = torch.clamp(_channel_amax(w) / E4M3_MAX, min=1e-12)
        return (w / scale).to(torch.float8_e4m3fn), scale

    return _quantize(state_dict, one)


def _gpu_has_fp8(kind: str) -> bool:
    """Whether a GPU named `kind` has fp8 tensor cores: Hopper, Blackwell
    and Ada do; Ampere and older (A100, V100, T4) emulate. Consumer Ada
    is "rtx 40xx" with exactly four digits; Turing's "quadro rtx 4000"
    has no fp8."""
    kind = kind.lower()
    if "quadro" in kind:
        return False
    if re.search(r"\brtx [45]0\d\d\b", kind):
        return True
    return any(re.search(rf"\b{t}\b", kind)
               for t in ("h100", "h200", "h800", "gh200", "b100", "b200", "gb200",
                         "l4", "l40", "l40s", "ada"))


def fp8_compute_supported(device: str | torch.device = "cuda") -> bool:
    """Does `device` run fp8 matmuls natively? Read from the GPU's name
    (`torch.cuda.get_device_name`); False on the CPU or without a GPU."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return False
    return _gpu_has_fp8(torch.cuda.get_device_name(device))


def quantized_bytes(state_dict: dict[str, torch.Tensor]) -> int:
    """Total bytes of the state dict as stored (q, scales and dense entries)."""
    return sum(t.numel() * t.element_size() for t in state_dict.values())

"""Device-memory report for one separation step (or one training step).

The port of `demucs_tpu/tools/memory_report.py`: capacity planning for
serving. Per model and configuration it reports the weights' bytes, the
input's and the output's, the activation workspace and the peak: what
decides how many sessions (`serving.DemixSession`) and what batch fit on
one card.

    python -m demucs_tpu_torch.tools.memory_report [--model 4s|6s|v3]
        [--batch 8] [--segment N] [--dtype bf16|f32] [--int8] [--json]
        [--train [--no-remat]] [--device cuda|cpu]

It measures the configuration its flags give, with the JAX tool's
defaults: batch 8 of the full segment, `--dtype bf16` (the port's
`--bf16` network); `--dtype f32` is the port's default network. `--int8`
keeps the weights int8, as the CLI's `--int8` does: the network stays
f32 and, with `--dtype bf16`, the weights widen to bf16 (`--bf16
--int8`), so the dense entries stay f32 (the JAX tool casts them to
bf16). The encoder skips are int8 when `DT_INT8_SKIPS=1`
(`models/htdemucs.py:INT8_SKIPS`; `int8_skips` in the report). `--train`
reports one f32 training step (forward, backward, Adam) at `--batch`,
with the per-layer remat of `--remat` (policy dots)
unless `--no-remat`. Random weights from seed 0.

The numbers come from torch's CUDA allocator around one call made after
a first, untimed one (cuDNN plans, the graph's cached constants), all
counted from what the process held before the model was built:
  * argument_bytes: the weights' bytes (the state dict's, exactly, as
    `weight_bytes`) plus the input's (`input_bytes`); for --train the
    parameters, Adam's moments, the mix and the references;
  * output_bytes: the output's (for --train the loss: the step updates
    the parameters and moments in place);
  * temp_bytes: the activation workspace, the peak less what was
    resident before the call (`resident_bytes`) and the output;
  * peak_bytes: `torch.cuda.max_memory_allocated` over the call;
    `reserved_peak_bytes` the allocator's reserved peak (`memory_stats`);
  * code_bytes: None (no compiled program; the kernels' libraries are
    not on the allocator).
On the CPU the byte counts of tensors (weights, input, output) are
exact and the allocator's numbers are None. Default device: cuda.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import SEGMENT_SAMPLES
from . import DTYPES, card_line, state_dict

_MODELS = {"4s": "htdemucs_4s", "6s": "htdemucs_6s", "v3": "hdemucs_v3"}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def state_bytes(sd: dict) -> int:
    """The bytes of a state dict's tensors: the weights' bytes."""
    return sum(_tensor_bytes(t) for t in sd.values())


def _measure(call, device: torch.device, base: int) -> dict:
    """Run `call` once untimed, then once between the allocator's
    readings; returns its output and the readings (None on the CPU)."""
    call()
    if device.type != "cuda":
        return dict(out=call(), resident=None, peak=None, reserved=None)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) - base
    out = call()
    torch.cuda.synchronize(device)
    return dict(out=out, resident=resident,
                peak=torch.cuda.max_memory_allocated(device) - base,
                reserved=torch.cuda.memory_stats(device)["reserved_bytes.all.peak"])


def _report(rec: dict, m: dict, out_bytes: int, args_bytes: int) -> dict:
    temp = None if m["peak"] is None else max(m["peak"] - m["resident"] - out_bytes, 0)
    rec.update(argument_bytes=args_bytes, output_bytes=out_bytes, temp_bytes=temp,
               code_bytes=None, peak_bytes=m["peak"], resident_bytes=m["resident"],
               reserved_peak_bytes=m["reserved"])
    return rec


def _base(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(device)


def compiled_memory(model: str = "4s", batch: int = 8, segment: int = SEGMENT_SAMPLES,
                    dtype=torch.bfloat16, int8: bool = False,
                    device: str | torch.device = "cuda") -> dict:
    """One segment call of `model` ("4s", "6s", "v3") on (batch, 2,
    segment) in `dtype` (torch.float32 or torch.bfloat16), int8 weights
    if `int8`: its device-memory budget in bytes (the module docstring)."""
    from ..models import build_model
    from ..models import htdemucs
    from ..utils.device import resolve_device
    from . import family

    device = resolve_device(device)
    name = {v: k for k, v in DTYPES.items()}[dtype]
    sd, quant_dtype = state_dict(_MODELS[model], name, "int8" if int8 else "none")
    base = _base(device)
    net = build_model(family(_MODELS[model])[0], sd, device, quant_dtype=quant_dtype)
    mix = torch.zeros(batch, 2, segment, device=device)
    with torch.inference_mode():
        m = _measure(lambda: net(mix), device, base)
    rec = dict(model=model, batch=batch, segment=segment, dtype="int8" if int8 else name,
               dtype_flag=name, int8_skips=htdemucs.INT8_SKIPS and model != "v3",
               weight_bytes=state_bytes(sd), input_bytes=_tensor_bytes(mix),
               device=card_line(device))
    return _report(rec, m, _tensor_bytes(m["out"]), rec["weight_bytes"] + rec["input_bytes"])


def train_compiled_memory(model: str = "4s", batch: int = 2, segment: int = SEGMENT_SAMPLES,
                          remat: bool = True, device: str | torch.device = "cuda") -> dict:
    """One f32 training step (forward, backward, Adam) of `model` at
    (batch, 2, segment), with the per-layer remat (policy dots) if
    `remat`: its device-memory budget in bytes (the module docstring)."""
    from ..models import build_model
    from ..train import TrainStep
    from ..utils.device import resolve_device
    from . import family

    device = resolve_device(device)
    cfg = family(_MODELS[model])[0]
    sd, _ = state_dict(_MODELS[model])
    base = _base(device)
    step = TrainStep(build_model(cfg, sd, device, train=True), remat=remat)
    gen = torch.Generator(device=device).manual_seed(0)
    mix = 0.1 * torch.randn(batch, 2, segment, device=device, generator=gen)
    refs = 0.05 * torch.randn(batch, cfg.num_sources, 2, segment, device=device, generator=gen)
    m = _measure(lambda: step(mix, refs), device, base)
    moments = [t for state in step.optimizer.state.values() for t in state.values()
               if torch.is_tensor(t)]
    args_bytes = (state_bytes(sd) + sum(_tensor_bytes(t) for t in moments)
                  + _tensor_bytes(mix) + _tensor_bytes(refs))
    rec = dict(model=model, batch=batch, segment=segment, remat=remat, mode="train",
               weight_bytes=state_bytes(sd), device=card_line(device))
    return _report(rec, m, _tensor_bytes(m["out"]), args_bytes)


def _fmt(n: int | None) -> str:
    return "not measured" if n is None else f"{n / 2**20:9.1f} MiB"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(_MODELS), default="4s")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment", type=int, default=SEGMENT_SAMPLES)
    ap.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="report the TRAINING step (fwd+bwd+Adam, f32)")
    ap.add_argument("--no-remat", action="store_true",
                    help="with --train: no per-layer remat")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.train:
        rep = train_compiled_memory(args.model, args.batch, args.segment,
                                    remat=not args.no_remat, device=args.device)
    else:
        rep = compiled_memory(args.model, args.batch, args.segment, DTYPES[args.dtype],
                              args.int8, device=args.device)
    if args.json:
        print(json.dumps(rep))
        return
    mode = (f"train remat={rep['remat']}" if args.train
            else f"dtype={rep['dtype']} int8_skips={rep['int8_skips']}")
    print(f"{_MODELS[args.model]}  batch={rep['batch']} segment={args.segment} {mode} "
          f"[{rep['device']}]")
    for k in ("weight_bytes", "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"):
        print(f"  {k[:-6]:<10}{_fmt(rep[k])}")


if __name__ == "__main__":
    main()

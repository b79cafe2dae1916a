"""The reference models built from a configuration file, the names and
shapes of their weights, and their operation counts.

A configuration file (`benchmark/configs/<name>.json`) holds its sizes
and names its plain model (`reference`, "<module of this package>:<class>");
`reference_model` builds that model from the sizes. The names and shapes of
its weights (`weight_shapes`) are what the benchmark draws seeded
weights for, so neither side's weights come from the program.
"""

from __future__ import annotations

import contextlib
import importlib
import types

import torch

from . import torch_ref, torch_ref_v3


def config_namespace(cfg: dict) -> types.SimpleNamespace:
    """The attributes the reference models read, derived from the file's
    sizes as the published models derive them."""
    ns = types.SimpleNamespace(**{k: v for k, v in cfg.items() if not isinstance(v, dict)})
    ns.sources = tuple(cfg["sources"])
    ns.num_sources = len(ns.sources)
    ns.freq_bins = cfg["nfft"] // 2
    ns.enc_channels = tuple(cfg["channels"] * cfg["growth"] ** i
                            for i in range(min(cfg["depth"], 4)))
    if "bottom_channels" in cfg:
        ns.t_dim = cfg["bottom_channels"] or ns.enc_channels[-1]
    return ns


def reference_model(cfg: dict) -> torch.nn.Module:
    """The plain model that `cfg` names, on the current default device."""
    module, cls = cfg["reference"].split(":")
    return getattr(importlib.import_module(f".{module}", __package__), cls)(config_namespace(cfg))


@contextlib.contextmanager
def uninitialized():
    """Module constructors inside the block skip their random init. On the
    meta device `nn.init.normal_` goes through `torch._refs`, whose first
    use imports `torch._dynamo`: seconds of every run's set-up, for
    values that are overwritten anyway."""
    names = [n for n in dir(torch.nn.init) if n.endswith("_") and not n.startswith("_")]
    saved = {n: getattr(torch.nn.init, n) for n in names}
    for n in names:
        setattr(torch.nn.init, n, lambda tensor, *args, **kwargs: tensor)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.nn.init, n, fn)


def meta_model(cfg: dict) -> torch.nn.Module:
    """The reference model on the meta device, its weights uninitialized."""
    with torch.device("meta"), uninitialized():
        return reference_model(cfg)


def weight_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every weight of the reference model, in its order."""
    return [(name, tuple(t.shape)) for name, t in meta_model(cfg).state_dict().items()]


@contextlib.contextmanager
def _istft_on_meta():
    """`torch.istft` has no meta kernel; it holds no product, so the count
    replaces it by a tensor of its output's shape."""
    def ispec(z, length, nfft=4096, hl=1024):
        return z.new_zeros(*z.shape[:-2], length, dtype=torch.float32)

    saved = torch_ref.ispec_torch, torch_ref_v3.ispec_torch
    torch_ref.ispec_torch = torch_ref_v3.ispec_torch = ispec
    try:
        yield
    finally:
        torch_ref.ispec_torch, torch_ref_v3.ispec_torch = saved


def count_operations(cfg: dict, segment_samples: int, backward: bool = False) -> int:
    """Floating-point operations of one segment through the reference
    model (with `backward`, its forward and backward), as
    `torch.utils.flop_counter` counts them on the meta device: the
    products (convolutions, linears, the attention's and LocalState's
    batched products, the LSTMs' gate products), two per multiply-add.
    FFTs, norms and elementwise work are not counted. The configuration
    files hold the result (`operations_per_segment`), since the count of
    hdemucs_mmi's 672 LSTM steps takes a minute on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    model = meta_model(cfg)
    with torch.device("meta"):
        mix = torch.zeros(1, cfg["audio_channels"], segment_samples)
    with _istft_on_meta(), FlopCounterMode(display=False) as counter:
        out = model(mix)
        if backward:
            out.abs().mean().backward()
    return int(counter.get_total_flops())

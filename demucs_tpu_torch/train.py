"""Training step for the htdemucs segment graph.

The port of `demucs_tpu/train.py` for single-device f32 training: the
per-source L1 loss on waveforms, Adam, the optional EMA of the weights,
and a crash-safe checkpoint of the whole training state.

The JAX package's `make_train_step` returns a jitted pure function over
a parameter pytree; here `TrainStep` holds the `nn.Module`, its
`torch.optim.Adam` and the EMA copy and updates them in place. The
forward, `backward()` and the optimizer update run inside one
`f32_precision()` scope, so no convolution or matmul of the backward
falls back to TF32 (the model's own inner scope restores only the flags
it changed, so it cannot turn TF32 back on), and inside one
`deterministic_cudnn()` scope, so cuDNN runs only its deterministic
algorithms. The crosstransformer's attention runs through
`ops.attention.FlashSDPA`: K2 forward and K3 backward on the GPU, 10
each per step; K3 sums dQ in a fixed order. So a step on the GPU is
bit-reproducible, and a resumed run equals an uninterrupted one bit for
bit, as on the CPU and in the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .utils.device import deterministic_cudnn, f32_precision

# optax.adam's defaults, which the JAX package trains with
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def l1_loss(model: torch.nn.Module, mix: torch.Tensor,
            refs: torch.Tensor) -> torch.Tensor:
    """Mean |model(mix) - refs| in f32. mix: (B, 2, L); refs: (B, S, 2, L).

    A mismatched batch would broadcast through the L1 silently, so it
    raises."""
    if mix.shape[0] != refs.shape[0]:
        raise ValueError(f"mix batch {mix.shape[0]} != refs batch {refs.shape[0]}")
    est = model(mix)
    return (est.float() - refs.float()).abs().mean()


class TrainStep:
    """One Adam step (and EMA update) on `model` per call.

        step = TrainStep(model, lr=3e-4, ema_decay=0.999)
        loss = step(mix, refs)          # a 0-d f32 tensor on the device

    The counterpart of `make_train_step` / `make_step_impl`. The EMA
    starts as a real copy of the parameters and follows
    e <- e * d + p * (1 - d) after every update. `step_count` counts the
    optimizer steps taken (restored by `load_train_state`).
    """

    def __init__(self, model: torch.nn.Module, lr: float = 3e-4,
                 ema_decay: float | None = None):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          betas=ADAM_BETAS, eps=ADAM_EPS)
        self.ema_decay = ema_decay
        self.ema = None
        if ema_decay is not None:
            self.ema = {name: p.detach().clone()
                        for name, p in model.named_parameters()}
        self.step_count = 0

    def __call__(self, mix: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        with f32_precision(), deterministic_cudnn():
            self.optimizer.zero_grad(set_to_none=True)
            loss = l1_loss(self.model, mix, refs)
            loss.backward()
            self.optimizer.step()
            if self.ema is not None:
                self._update_ema()
        self.step_count += 1
        return loss.detach()

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        for name, p in self.model.named_parameters():
            self.ema[name].mul_(d).add_(p.detach(), alpha=1.0 - d)

    def export_weights(self) -> dict[str, torch.Tensor]:
        """The weights to ship: the EMA when it is kept (the upstream
        convention), else the trained parameters; flat state-dict names."""
        if self.ema is not None:
            return dict(self.ema)
        return {name: p.detach() for name, p in self.model.named_parameters()}


def _siblings(path: Path) -> tuple[Path, Path]:
    return path.with_name(path.name + ".new"), path.with_name(path.name + ".old")


def save_train_state(path, step: TrainStep) -> None:
    """Checkpoint {step, params, optimizer, ema} with `torch.save`.

    Params and the EMA are flat state-dict names, on the CPU, so a
    checkpoint's weights also load for inference. Crash-safe overwrite,
    as in the JAX package: the new state is written next to the live
    file, then swapped in with renames, so a kill during the save leaves
    the previous checkpoint intact. If a crash landed between the two
    renames, the complete state in `.new` (or `.old`) is promoted back
    first, so the cleanup never deletes the only copy."""
    path = Path(path).absolute()
    new, old = _siblings(path)
    if not path.exists():
        for cand in (new, old):
            if cand.exists():
                cand.rename(path)
                break
    for stale in (new, old):
        stale.unlink(missing_ok=True)
    cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    state = {
        "step": step.step_count,
        "params": {name: cpu(p) for name, p in step.model.named_parameters()},
        "optimizer": step.optimizer.state_dict(),
        "ema": None if step.ema is None else {k: cpu(v) for k, v in step.ema.items()},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(new, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        path.rename(old)
    new.rename(path)
    old.unlink(missing_ok=True)


def load_train_state(path, step: TrainStep) -> int:
    """Restore params, optimizer state, step count and EMA from
    `save_train_state` into `step` (its model on its own device); returns
    the step count; the learning rate stays `step`'s own. If the live file
    is missing (a crash between the save's renames), `.new`, the newer
    complete state, is taken, else `.old`. A checkpoint without an EMA
    starts the EMA from the restored parameters."""
    path = Path(path).absolute()
    if not path.exists():
        for cand in _siblings(path):
            if cand.exists():
                path = cand
                break
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = dict(step.model.named_parameters())
    if set(state["params"]) != set(params):
        raise ValueError(f"{path}: checkpoint parameters do not match the model")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
    # the learning rate stays the caller's, as in the JAX package, whose
    # optimizer state does not hold it (torch's state dict does)
    lrs = [group["lr"] for group in step.optimizer.param_groups]
    step.optimizer.load_state_dict(state["optimizer"])
    for group, lr in zip(step.optimizer.param_groups, lrs):
        group["lr"] = lr
    if step.ema is not None:
        source = state["ema"] if state["ema"] is not None else state["params"]
        for name, e in step.ema.items():
            e.copy_(source[name])
    step.step_count = int(state["step"])
    return step.step_count

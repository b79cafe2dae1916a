"""Training step for the htdemucs and hdemucs_mmi segment graphs.

The port of `demucs_tpu/train.py` for single-device training: the
per-source L1 loss on waveforms, Adam, the optional EMA of the weights,
rematerialization (`remat`, `remat_policy`), bf16 compute from f32
master weights (`compute_dtype`), K steps per call (`TrainStep.steps`),
and a crash-safe checkpoint of the whole training state.

The JAX package's `make_train_step` returns a jitted pure function over
a parameter pytree; here `TrainStep` holds the `nn.Module`, its
`torch.optim.Adam` and the EMA copy and updates them in place. The
forward, `backward()` and the optimizer update run inside one
`f32_precision()` scope, so no convolution or matmul of the backward
falls back to TF32 (the model's own inner scope restores only the flags
it changed, so it cannot turn TF32 back on), and inside one
`deterministic_cudnn()` scope, so cuDNN runs only its deterministic
algorithms. The kernels train through autograd Functions: v4's
attention through `ops.attention.FlashSDPA` (K2 forward, K3 backward,
10 each per step; K3 sums dQ in a fixed order), the DConv sub-blocks
through `ops.DConvSubBlock` (K5), v3's BiLSTM recurrences through
`ops.BiLSTMRecurrence` (K6) and its DConv tails through
`ops.GnGluScaleRes` (K4); the last three recompute their plain twins in
the backward. So a step on the GPU is bit-reproducible, and a resumed
run equals an uninterrupted one bit for bit, as on the CPU and in the
JAX package.

`ShardedTrainStep` is the counterpart of `make_sharded_train_step`: the
same step over a (bag, dp, tp) mesh of ranks (`parallel/`), the batch
split over dp, the transformer's projections over tp (the model built
with the tp group on this rank's slice of the weights), Adam's moments
and the EMA held like their parameter. Its checkpoint is the full state,
gathered from the ranks, in the single-device format.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .ops.cuda import flash_attention
from .parallel import axis_group, axis_rank, axis_size, gather_state_dict
from .parallel.sharding import gather_tensor, shard_tensor
from .utils import profiling
from .utils.device import deterministic_cudnn, f32_precision

# optax.adam's defaults, which the JAX package trains with
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

_aten = torch.ops.aten
# The products whose outputs `remat_policy="dots"` keeps, and of them those
# without batch dimensions, which "dots_nb" keeps. The JAX policies save the
# outputs of `dot_general` and `conv_general_dilated` ("dots") and of the
# `dot_general`s without batch dimensions ("dots_nb"). The JAX package runs
# its convolutions as einsums that contract channels, with no batch
# dimension (`demucs_tpu/ops/conv.py`: `_tap_conv`, `_chunked_strided_conv`,
# the F-major forms), where the port runs them as cuDNN convolutions: so a
# convolution counts under both policies. A matmul of a weight (`mm`,
# `addmm`: the linears, the BiLSTM's input projection) counts under both; a
# batched product (`bmm`, `baddbmm`: LocalState's einsums) and the
# attention's forward kernel (K2, whose products carry the batch and head
# dimensions) only under "dots". The fused kernels
# K5 (a DConv sub-block), K4 (its tail) and K6 (the recurrence) end in
# elementwise ops and are recomputed under every policy, as everything is
# under "none".
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default,
                            _aten.convolution.default})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default,
                          flash_attention._flash_mha_fwd_op}
REMAT_POLICIES = {
    "dots": _DOTS,        # jax.checkpoint_policies.dots_saveable
    "none": frozenset(),  # nothing_saveable: recompute every op
    "dots_nb": _NO_BATCH_DOTS,  # dots_with_no_batch_dims_saveable
}


def _remat_context(policy: str):
    """The selective checkpoint context of `policy`: the outputs of its
    ops are kept from the forward, every other op is run again in the
    backward."""
    saved = REMAT_POLICIES[policy]

    def keep(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(keep)


class _ClassForward(torch.nn.Module):
    """Runs its module's class forward: a `functional_call` of it reaches
    the module's code past a forward that `rematerialized` set on the
    instance."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        return type(self.module).forward(self.module, *args, **kwargs)


@contextlib.contextmanager
def rematerialized(model: torch.nn.Module, policy: str,
                   params: dict[str, torch.Tensor] | None = None):
    """Inside the block, each module of `model.remat_blocks()` runs its
    forward as a region of its own under `torch.utils.checkpoint`
    (non-reentrant), keeping what `REMAT_POLICIES[policy]` names and
    running the rest again when the backward reaches that region.

    `params` are the tensors (by the model's parameter names) that a
    `torch.func.functional_call` of the model puts in place of its
    parameters around the forward (bf16 compute). The backward recomputes
    a region after that call has put the parameters back, so each region
    puts its own share of `params` in place again, in its forward and in
    its recompute."""
    names = {id(m): name for name, m in model.named_modules()}

    def region(block):
        fn = block.forward
        if params is not None:
            prefix = names[id(block)] + "."
            own = {"module." + k[len(prefix):]: v for k, v in params.items()
                   if k.startswith(prefix)}
            proxy = _ClassForward(block)

            def fn(*args, **kwargs):
                return torch.func.functional_call(proxy, own, args, kwargs)

        def run(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=lambda: _remat_context(policy), **kwargs)
        return run

    blocks = model.remat_blocks()
    for block in blocks:
        block.forward = region(block)
    try:
        yield
    finally:
        for block in blocks:
            del block.forward  # the class's forward again


def l1_loss(model: torch.nn.Module, mix: torch.Tensor, refs: torch.Tensor,
            remat: bool = False, remat_policy: str = "dots",
            compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Mean |model(mix) - refs| in f32. mix: (B, 2, L); refs: (B, S, 2, L).

    remat: the segment forward rematerialized, as `jax.checkpoint` with
    the JAX package's policy: each of `model.remat_blocks()` (the
    encoder, decoder and transformer layers) is a checkpoint region
    (`rematerialized`). One region over the whole segment would not lower
    the peak: its backward recomputes every activation before it starts
    (measured on an H100, `--remat none` at v4 batch 4: 15.47 GB against
    15.46 without remat); a region per layer holds one layer's. The
    arithmetic is the same either way, bit for bit no remat's.
    compute_dtype (torch.bfloat16): the forward and backward run on the
    float parameters cast to it, differentiably (the cast is inside the
    loss, so the gradients come back to the f32 parameters in f32), on
    the mix cast to it; the L1 is taken in f32.

    A mismatched batch would broadcast through the L1 silently, so it
    raises."""
    if mix.shape[0] != refs.shape[0]:
        raise ValueError(f"mix batch {mix.shape[0]} != refs batch {refs.shape[0]}")
    cast = None
    if compute_dtype is not None:
        cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
                for name, p in model.named_parameters()}
        mix = mix.to(compute_dtype)
    regions = rematerialized(model, remat_policy, cast) if remat else contextlib.nullcontext()
    with regions:
        est = model(mix) if cast is None else torch.func.functional_call(model, cast, (mix,))
    return (est.float() - refs.float()).abs().mean()


class TrainStep:
    """One Adam step (and EMA update) on `model` per call.

        step = TrainStep(model, lr=3e-4, ema_decay=0.999)
        loss = step(mix, refs)          # a 0-d f32 tensor on the device
        losses = step.steps(mixes, refss)   # K steps: (K, B, ...) -> (K,)

    The counterpart of `make_train_step` / `make_step_impl`, and with
    `steps` of `make_multi_train_step`. `remat`, `remat_policy` and
    `compute_dtype` are `l1_loss`'s. The parameters, their gradients, Adam's
    moments and the EMA stay f32 whatever `compute_dtype` is. The EMA
    starts as a real copy of the parameters and follows
    e <- e * d + p * (1 - d) after every update. `step_count` counts the
    optimizer steps taken (restored by `load_train_state`).
    """

    def __init__(self, model: torch.nn.Module, lr: float = 3e-4,
                 ema_decay: float | None = None, remat: bool = False,
                 remat_policy: str = "dots", compute_dtype: torch.dtype | None = None):
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {sorted(REMAT_POLICIES)}")
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          betas=ADAM_BETAS, eps=ADAM_EPS)
        self.ema_decay = ema_decay
        self.ema = None
        if ema_decay is not None:
            self.ema = {name: p.detach().clone()
                        for name, p in model.named_parameters()}
        self.loss_options = dict(remat=remat, remat_policy=remat_policy,
                                 compute_dtype=compute_dtype)
        self.step_count = 0

    def __call__(self, mix: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        with profiling.span("train.step"), f32_precision(), deterministic_cudnn():
            self.optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.forward"):
                loss = l1_loss(self.model, mix, refs, **self.loss_options)
            with profiling.span("train.backward"):
                loss.backward()
                self._reduce_gradients()
            with profiling.span("train.optimizer"):
                self.optimizer.step()
            if self.ema is not None:
                with profiling.span("train.ema"):
                    self._update_ema()
        self.step_count += 1
        return loss.detach()

    def steps(self, mixes: torch.Tensor, refss: torch.Tensor) -> torch.Tensor:
        """K steps on the K batches stacked in mixes (K, B, 2, L) and refss
        (K, B, S, 2, L), each one step as `__call__` takes it; returns the K
        losses as one (K,) tensor on the device, so a caller fetches them
        once."""
        if mixes.shape[0] != refss.shape[0]:
            raise ValueError(f"{mixes.shape[0]} mixes for {refss.shape[0]} refs")
        return torch.stack([self(mix, refs) for mix, refs in zip(mixes, refss)])

    def _reduce_gradients(self) -> None:
        """Between the backward and the update: nothing on one device."""

    def checkpoint_state(self) -> dict:
        """{step, params, optimizer, ema}, every tensor copied to the CPU:
        what `save_train_state` writes."""
        return _checkpoint_state(self)

    def restore_checkpoint_state(self, state: dict) -> int:
        """Put a `checkpoint_state` into this step; returns its step count."""
        return _restore(self, state)

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
    first, so the cleanup never deletes the only copy. A
    `ShardedTrainStep` writes the state gathered from every rank; each
    rank must call `checkpoint_state` then, and one of them
    `write_train_state`."""
    write_train_state(path, step.checkpoint_state())


def write_train_state(path, state: dict) -> None:
    """Write a checkpoint state (`TrainStep.checkpoint_state`) as
    `save_train_state` does."""
    path = Path(path).absolute()
    new, old = _siblings(path)
    if not path.exists():
        for cand in (new, old):
            if cand.exists():
                cand.rename(path)
                break
    for stale in (new, old):
        stale.unlink(missing_ok=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(new, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        path.rename(old)
    new.rename(path)
    old.unlink(missing_ok=True)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _checkpoint_state(step: TrainStep, full=lambda name, t: t) -> dict:
    """The state `save_train_state` writes, each parameter-shaped tensor
    passed through `full(name, tensor)` first."""
    names = [name for name, _ in step.model.named_parameters()]
    optimizer = step.optimizer.state_dict()
    optimizer["state"] = {
        i: {k: _cpu(full(names[i], v)) if k != "step" else v for k, v in st.items()}
        for i, st in optimizer["state"].items()}
    return {
        "step": step.step_count,
        "params": {name: _cpu(full(name, p)) for name, p in step.model.named_parameters()},
        "optimizer": optimizer,
        "ema": None if step.ema is None else {k: _cpu(full(k, v)) for k, v in step.ema.items()},
    }


def load_train_state(path, step: TrainStep) -> int:
    """Restore params, optimizer state, step count and EMA from
    `save_train_state` into `step` (its model on its own device); returns
    the step count; the learning rate stays `step`'s own. If the live file
    is missing (a crash between the save's renames), `.new`, the newer
    complete state, is taken, else `.old`. A checkpoint without an EMA
    starts the EMA from the restored parameters. A `ShardedTrainStep`
    takes its rank's slice of the full state."""
    path = Path(path).absolute()
    if not path.exists():
        for cand in _siblings(path):
            if cand.exists():
                path = cand
                break
    state = torch.load(path, map_location="cpu", weights_only=True)
    if set(state["params"]) != {name for name, _ in step.model.named_parameters()}:
        raise ValueError(f"{path}: checkpoint parameters do not match the model")
    return step.restore_checkpoint_state(state)


def _restore(step: TrainStep, state: dict, part=lambda name, t: t) -> int:
    """Put a checkpoint state into `step`, each parameter-shaped tensor
    passed through `part(name, tensor)` first."""
    params = dict(step.model.named_parameters())
    names = list(params)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(part(name, state["params"][name]))
    # the learning rate stays the caller's, as in the JAX package, whose
    # optimizer state does not hold it (torch's state dict does)
    lrs = [group["lr"] for group in step.optimizer.param_groups]
    optimizer = dict(state["optimizer"])
    optimizer["state"] = {
        i: {k: part(names[int(i)], v) if k != "step" else v for k, v in st.items()}
        for i, st in optimizer["state"].items()}
    step.optimizer.load_state_dict(optimizer)
    for group, lr in zip(step.optimizer.param_groups, lrs):
        group["lr"] = lr
    if step.ema is not None:
        source = state["ema"] if state["ema"] is not None else state["params"]
        for name, e in step.ema.items():
            e.copy_(part(name, source[name]))
    step.step_count = int(state["step"])
    return step.step_count


class ShardedTrainStep(TrainStep):
    """`TrainStep` over a mesh of ranks: the counterpart of
    `make_sharded_train_step`.

        step = ShardedTrainStep(model, mesh, lr=3e-4, ema_decay=0.999)
        loss = step(mix, refs)   # the GLOBAL batch, the same on every rank

    `model` is this rank's, built with the mesh's tp group on this rank's
    slice of the weights (`parallel.shard_state_dict`), so Adam's moments
    and the EMA, made from its parameters, are sharded like them. Each
    call takes this rank's dp slice of the global batch (whose size dp
    must divide), and after the backward averages the gradients over dp,
    so the update is that of the global batch's mean loss, which it
    returns. Every rank of the mesh makes every call."""

    def __init__(self, model: torch.nn.Module, mesh, **options):
        super().__init__(model, **options)
        self.mesh = mesh
        self.dp = axis_size(mesh, "dp")
        self.dp_rank = axis_rank(mesh, "dp")
        self.dp_group = axis_group(mesh, "dp")

    def __call__(self, mix: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        if mix.shape[0] % self.dp:
            raise ValueError(f"a batch of {mix.shape[0]} does not split over dp={self.dp}")
        n = mix.shape[0] // self.dp
        rows = slice(self.dp_rank * n, (self.dp_rank + 1) * n)
        loss = super().__call__(mix[rows], refs[rows])
        if self.dp > 1:
            dist.all_reduce(loss, group=self.dp_group)
            loss /= self.dp
        return loss

    @torch.no_grad()
    def _reduce_gradients(self) -> None:
        """The mean over dp of the ranks' gradients, in one all-reduce."""
        if self.dp == 1:
            return
        grads = [p.grad for p in self.model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.dp_group)
        flat /= self.dp
        pos = 0
        for g in grads:
            g.copy_(flat[pos:pos + g.numel()].view_as(g))
            pos += g.numel()

    def export_weights(self) -> dict[str, torch.Tensor]:
        """The full weights to ship, gathered from the tp ranks (a
        collective: every rank calls it)."""
        return gather_state_dict(super().export_weights(), self.mesh)

    def checkpoint_state(self) -> dict:
        """The full state, gathered from the ranks (every rank calls it)."""
        return _checkpoint_state(self, lambda name, t: gather_tensor(name, t, self.mesh))

    def restore_checkpoint_state(self, state: dict) -> int:
        """Restore this rank's slice of a full state."""
        tp, rank = axis_size(self.mesh, "tp"), axis_rank(self.mesh, "tp")
        return _restore(self, state, lambda name, t: shard_tensor(name, t, tp, rank))

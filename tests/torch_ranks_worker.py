"""One rank of the port's multi-rank CPU tests (`tests/test_torch_parallel.py`).

    python torch_ranks_worker.py RANK WORLD PORT DIR

DIR holds `inputs.npz`, written by the test: weights (`seed{N}/{name}`,
the JAX package's `init_flat` of the narrow htdemucs-4s of the test) and
inputs. The ranks join a gloo group on the CPU at 127.0.0.1:PORT and
run the port's sharded paths; rank 0 writes `out.npz` to DIR. With 2
ranks: dp=2 and tp=2 segment calls (dense and --int8), ShardedSeparator
(batched and fused, dp=2), two training steps at tp=2 and at dp=2 (the
first step's dp-averaged gradients kept), a tp=2 layer's
gradients against the whole layer's, the shard/gather round trip and the
checks that raise; with 4 ranks: the bag over bag=4. Imports no JAX.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_model
from demucs_tpu_torch.models.htdemucs import CrossTransformerLayer
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.params.quant import quantize_int8
from demucs_tpu_torch.parallel import (ShardedSeparator, axis_group, bag_share,
                                       gather_state_dict, init_distributed, make_bag_fn,
                                       make_mesh, make_sharded_fn, shard_state_dict)
from demucs_tpu_torch.parallel import mesh as mesh_module
from demucs_tpu_torch.pipeline import ApplyOptions
from demucs_tpu_torch.train import ShardedTrainStep

CFG = dataclasses.replace(HTDEMUCS_4S, channels=8, bottom_channels=64, t_layers=3)
LR, EMA = 1e-3, 0.9


def weights(inputs, seed: int) -> dict:
    prefix = f"seed{seed}/"
    return from_jax_params({k[len(prefix):]: inputs[k] for k in inputs.files
                            if k.startswith(prefix)})


def model_on(mesh, sd, train=False):
    return build_model(CFG, shard_state_dict(sd, mesh), "cpu", train=train,
                       tp_group=axis_group(mesh, "tp"))


class Positional(torch.nn.Module):
    """The JAX separator tests' translation-sensitive toy: (B, C, T) ->
    (B, 2, C, T), a ramp times the mix and times the mix delayed by 3."""

    def forward(self, mix):
        T = mix.shape[-1]
        ramp = 0.5 + torch.arange(T, dtype=torch.float32) / (2 * T)
        d1 = torch.nn.functional.pad(mix, (3, 0))[:, :, :T]
        return torch.stack([mix * ramp, d1 * ramp], dim=1)


def two_ranks(inputs, out: dict) -> None:
    rank = dist.get_rank()
    with torch.inference_mode():
        mesh = make_mesh(tp=1, device_type="cpu")  # dp = 2
        mix = torch.from_numpy(inputs["mix_dp"])
        out["dp"] = make_sharded_fn(model_on(mesh, weights(inputs, 3)), mesh)(mix).numpy()
        # an odd batch: padded to a multiple of dp, the pad cut off
        out["dp_odd"] = make_sharded_fn(model_on(mesh, weights(inputs, 3)), mesh)(
            mix[:3]).numpy()

        opts = ApplyOptions(segment_samples=4096, batch_size=3, shift_offset=55,
                            max_shift_secs=0.02)
        sep = ShardedSeparator(Positional(), 2, mesh, opts, device="cpu")
        out["options_batch"] = np.array([opts.batch_size, sep.options.batch_size])
        audio = inputs["audio"]
        out["sep_batched"] = sep(audio)
        out["sep_fused"] = ShardedSeparator(
            Positional(), 2, mesh, dataclasses.replace(opts, fused_track=True),
            device="cpu")(audio)

        tp_mesh = make_mesh(tp=2, device_type="cpu")  # tp = 2, dp = 1
        out["multihost_shape"] = np.array(tp_mesh.shape)
        try:
            make_mesh(tp=4, device_type="cpu")
        except ValueError:
            out["multihost_tp4_raises"] = np.array(True)
        # each rank as if on a host of its own: a tp group may not span
        # them, a dp group may
        real_host = mesh_module._host
        mesh_module._host = lambda: f"host{rank}"
        try:
            try:
                make_mesh(tp=2, device_type="cpu")
            except ValueError:
                out["cross_host_tp_raises"] = np.array(True)
            out["cross_host_dp_shape"] = np.array(make_mesh(tp=1, device_type="cpu").shape)
        finally:
            mesh_module._host = real_host
        mix = torch.from_numpy(inputs["mix_tp"])
        sd = weights(inputs, 4)
        out["tp"] = make_sharded_fn(model_on(tp_mesh, sd), tp_mesh)(mix).numpy()
        out["tp_int8"] = make_sharded_fn(model_on(tp_mesh, quantize_int8(sd)), tp_mesh)(
            mix).numpy()
        # shard then gather gives the state dict back, bit for bit
        back = gather_state_dict(shard_state_dict(sd, tp_mesh), tp_mesh)
        out["roundtrip_equal"] = np.array(all(torch.equal(back[k], sd[k]) for k in sd))
        q = quantize_int8(sd)
        qs = shard_state_dict(q, tp_mesh)
        name = "crosstransformer.layers.0.self_attn.in_proj_weight"
        out["int8_in_proj_q"] = qs[name + ".q"].numpy()
        out["int8_in_proj_scale"] = qs[name + ".scale"].numpy()
        name = "crosstransformer.layers.0.linear2.weight"
        out["int8_linear2_q"] = qs[name + ".q"].numpy()
        out["int8_linear2_scale"] = qs[name + ".scale"].numpy()
        out["tp_rank"] = np.array(tp_mesh.get_local_rank("tp"))

    # two Adam steps of the tp = 2 step, the EMA on, the state gathered
    sd = weights(inputs, 0)
    step = ShardedTrainStep(model_on(tp_mesh, sd, train=True), tp_mesh, lr=LR, ema_decay=EMA)
    mix, refs = torch.from_numpy(inputs["train_mix"]), torch.from_numpy(inputs["train_refs"])
    losses = [step(mix, refs).item() for _ in range(2)]
    state = step.checkpoint_state()
    out["train_loss"] = np.array(losses)
    for k, v in state["params"].items():
        out[f"train_params/{k}"] = v.numpy()
    for k, v in state["ema"].items():
        out[f"train_ema/{k}"] = v.numpy()
    # the same two steps at dp = 2: the batch split, the gradients averaged
    step = ShardedTrainStep(model_on(mesh, sd, train=True), mesh, lr=LR, ema_decay=EMA)
    losses = [step(mix, refs).item()]
    # the first step's gradients, averaged over dp (tp = 1: whole on every rank)
    for k, p in step.model.named_parameters():
        out[f"train_dp_grads/{k}"] = p.grad.numpy().copy()
    losses.append(step(mix, refs).item())
    out["train_dp_loss"] = np.array(losses)
    for k, v in step.checkpoint_state()["params"].items():
        out[f"train_dp_params/{k}"] = v.numpy()
    try:
        step(mix[:1], refs[:1])
    except ValueError:
        out["odd_batch_raises"] = np.array(True)

    # a tp = 2 layer against the whole layer: the output and every gradient
    gen = torch.Generator().manual_seed(0)
    d, hidden = CFG.t_dim, 4 * CFG.t_dim
    for cross in (False, True):
        whole = CrossTransformerLayer(d, CFG.t_heads, hidden, cross)
        with torch.no_grad():
            for p in whole.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        part = CrossTransformerLayer(d, CFG.t_heads, hidden, cross, axis_group(tp_mesh, "tp"))
        full = dict(whole.named_parameters())
        shards = shard_state_dict({k: v.detach() for k, v in full.items()}, tp_mesh)
        part.load_state_dict(shards)
        x = torch.randn(2, 24, d, generator=gen)
        kv = torch.randn(2, 16, d, generator=gen) if cross else None
        xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
        kvs = [None, None] if kv is None else [kv.clone().requires_grad_(),
                                               kv.clone().requires_grad_()]
        w = torch.randn(2, 24, d, generator=gen)
        ys = [layer(xi, ki) for layer, xi, ki in zip((whole, part), xs, kvs)]
        for y in ys:
            (y * w).sum().backward()
        tag = "cross" if cross else "self"
        out[f"grad_{tag}/y_err"] = (ys[1] - ys[0]).abs().max().detach().numpy()
        out[f"grad_{tag}/x_err"] = (xs[1].grad - xs[0].grad).abs().max().numpy()
        out[f"grad_{tag}/x_scale"] = xs[0].grad.abs().max().numpy()
        if cross:
            out[f"grad_{tag}/kv_err"] = (kvs[1].grad - kvs[0].grad).abs().max().numpy()
        grads = gather_state_dict({k: p.grad for k, p in part.named_parameters()}, tp_mesh)
        for k, p in full.items():
            out[f"grad_{tag}/{k}/err"] = (grads[k] - p.grad).abs().max().numpy()
            out[f"grad_{tag}/{k}/scale"] = p.grad.abs().max().numpy()
    if rank != 0:
        out.clear()


def four_ranks(inputs, out: dict) -> None:
    mesh = make_mesh(bag=4, device_type="cpu")  # bag = 4, dp = 1
    share = bag_share(mesh, 4)
    with torch.inference_mode():
        models = [model_on(mesh, weights(inputs, s)) for s in share]
        out["bag"] = make_bag_fn(models, mesh)(torch.from_numpy(inputs["mix_bag"])).numpy()
    out["share"] = np.array(list(share))


def main() -> None:
    rank, world, port, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    init_distributed(rank, world, f"tcp://127.0.0.1:{port}", "cpu")
    try:
        inputs = np.load(where / "inputs.npz")
        out: dict = {}
        (two_ranks if world == 2 else four_ranks)(inputs, out)
        if world == 4:
            shares = [None] * world
            dist.all_gather_object(shares, out.pop("share").tolist())
            out["shares"] = np.array(shares)
        if rank == 0:
            np.savez(where / "out.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

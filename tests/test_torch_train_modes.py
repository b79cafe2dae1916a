"""The training modes of demucs_tpu_torch against demucs_tpu on the CPU:
rematerialization (`remat`, `remat_policy`), bf16 compute and K steps
per call, on the tiny htdemucs-4s of tests/test_torch_train.py (channels
8, bottom 32, 3 transformer layers, 8192 samples, batch 2) with the same
`init_flat` weights and numpy batch.

Tolerances:
  * remat, every policy: the port's loss and gradients equal its own
    without remat bit for bit (the same ops run again on the same inputs),
    and are held to `l1_loss(remat=True)` of the JAX package as
    tests/test_torch_train.py holds the step without remat (loss 1e-5
    relative; each gradient 3e-4 of its largest entry, the
    GroupNorm-removed mean of the DConv conv biases' to 1e-3 of the
    largest entry of all);
  * bf16 compute: the gradients are f32 and finite; against the f32
    gradients (the JAX package's, of `l1_loss(remat=True)`), the median
    over the tensors of |g_bf16 - g_f32| / |g_f32| (Frobenius norms) is
    under the JAX package's own bound for its bf16 compute, 0.15
    (tests/test_train.py), and under 0.06, this port's (measured 0.038;
    the JAX package's own bf16 gradients: 0.049); against the JAX
    package's bf16 gradients, that median of |g_port - g_jax| / |g_f32|
    is at most twice the JAX package's own bf16 error (measured 0.054
    against 0.049), and the loss is within 1e-4 relative of both;
  * K steps per call: bit for bit K single steps in the port (losses,
    parameters, EMA); against `make_multi_train_step` under SGD at
    tests/test_train.py's tolerances (losses rtol 2e-6, parameters atol
    1e-5; measured 1.2e-7 and 1.9e-9).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import optax

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.train import l1_loss as jax_l1_loss
from demucs_tpu.train import make_multi_train_step

from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.data import augmented_step, augmented_steps, draw_augmentation
from demucs_tpu_torch.models import build_model, feeds_group_norm
from demucs_tpu_torch.ops.cuda.flash_attention import _flash_mha_bwd_op, _flash_mha_fwd_op
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.tools.train_cli import main as train_main
from demucs_tpu_torch.train import REMAT_POLICIES, TrainStep, l1_loss

from _torch_threads import _one_torch_thread  # noqa: F401

TINY = dict(channels=8, bottom_channels=32, t_layers=3)
JCFG = dataclasses.replace(J4S, **TINY)
CFG = dataclasses.replace(HTDEMUCS_4S, **TINY)
SEG = 8192
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
ZERO_GRAD = 1e-3
BF16_MEDIAN_JAX, BF16_MEDIAN = 0.15, 0.06
K = 3


@pytest.fixture(scope="module")
def tiny():
    flat = JP.init_flat(JP.htdemucs_schema(JCFG), seed=0)
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, SEG)) * 0.1).astype(np.float32)
    refs = (rng.standard_normal((2, 4, 2, SEG)) * 0.05).astype(np.float32)
    return flat, mix, refs


def _jax_loss_and_grads(tiny, **kw):
    flat, mix, refs = tiny
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(flat))
    fn = jax.jit(jax.value_and_grad(lambda p, m, r: jax_l1_loss(p, m, r, JCFG, **kw)))
    loss, grads = fn(p, jnp.asarray(mix), jnp.asarray(refs))
    return float(loss), {k: np.asarray(v) for k, v in JP.flatten_tree(grads).items()}


@pytest.fixture(scope="module")
def jax_remat(tiny):
    """The JAX package's loss and gradients of l1_loss(remat=True) (its
    default policy, "dots")."""
    return _jax_loss_and_grads(tiny, remat=True)


@pytest.fixture(scope="module")
def jax_bf16(tiny):
    return _jax_loss_and_grads(tiny, compute_dtype=jnp.bfloat16)


def _port(tiny, **kw):
    """The port's loss and gradients of l1_loss(**kw), from a fresh model."""
    flat, mix, refs = tiny
    model = build_model(CFG, from_jax_params(flat), "cpu", train=True)
    loss = l1_loss(model, torch.from_numpy(mix), torch.from_numpy(refs), **kw)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_plain(tiny):
    return _port(tiny)


# --- remat -------------------------------------------------------------------------

@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_equals_no_remat_and_jax(tiny, port_plain, jax_remat, policy):
    loss, grads = _port(tiny, remat=True, remat_policy=policy)
    assert torch.equal(loss, port_plain[0])
    for name, g in grads.items():
        assert torch.equal(g, port_plain[1][name]), name
    jloss, jgrads = jax_remat
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    top = max(np.abs(g).max() for g in jgrads.values())
    for name, ref in jgrads.items():
        ours = grads[name].numpy()
        if feeds_group_norm(name):
            for g in (ours, ref):
                assert abs(g.mean()) <= ZERO_GRAD * top, (name, g.mean())
            ours, ref = ours - ours.mean(), ref - ref.mean()
        err = np.abs(ours - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_remat_with_bf16_compute_equals_bf16_compute(tiny, policy):
    """Remat under bf16 compute: the backward recomputes each layer on the
    bf16 weights, as the forward ran (not on the f32 parameters, which
    are back in place once the forward's functional_call returns), so the
    loss and every gradient are bit for bit those of bf16 compute alone."""
    loss0, grads0 = _port(tiny, compute_dtype=torch.bfloat16)
    loss1, grads1 = _port(tiny, compute_dtype=torch.bfloat16, remat=True, remat_policy=policy)
    assert torch.equal(loss0, loss1)
    for name, g in grads1.items():
        assert torch.equal(g, grads0[name]), name


class _CountOps(TorchDispatchMode):
    """Counts the calls of each op under it, and apart those made inside
    the forward of one of `blocks`; records the dtypes of each call's
    tensor arguments."""

    def __init__(self, blocks=()):
        super().__init__()
        self.counts, self.inside, self.dtypes, self.depth = {}, {}, {}, 0
        self.hooks = [h for b in blocks for h in (
            b.register_forward_pre_hook(lambda *_: self._enter(1)),
            b.register_forward_hook(lambda *_: self._enter(-1)))]

    def _enter(self, step):
        self.depth += step

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        self.dtypes.setdefault(func, []).append(
            tuple(a.dtype for a in args if isinstance(a, torch.Tensor)))
        if self.depth:
            self.inside[func] = self.inside.get(func, 0) + 1
        return func(*args, **(kwargs or {}))

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        return super().__exit__(*exc)


@pytest.mark.parametrize("policy", [None, *sorted(REMAT_POLICIES)])
def test_remat_policy_decides_what_runs_again(tiny, policy):
    """What each policy runs again in the backward, counted by op: of the
    ops inside the rematerialized layers (`remat_blocks`), the forward
    convolutions (dots and dots_nb keep them), the attention's forward
    kernel op (K2; dots keeps it, dots_nb recomputes it: its products
    carry the batch and head dimensions) and the elementwise ops (every
    policy recomputes them); "none" runs every op of the layers again,
    but for what no backward needs: the recompute of a region stops once
    the tensors its backward saves are back, so a layer's last
    convolution may not run again (at most one a layer)."""
    flat, mix, refs = tiny
    model = build_model(CFG, from_jax_params(flat), "cpu", train=True)
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    with _CountOps(model.remat_blocks()) as fwd:
        loss = l1_loss(model, torch.from_numpy(mix), torch.from_numpy(refs), **kw)
    with _CountOps() as bwd:
        loss.backward()
    # GELU's erf: its derivative is an exp, so no backward runs an erf
    conv, attn, gelu = (torch.ops.aten.convolution.default, _flash_mha_fwd_op,
                        torch.ops.aten.erf.default)
    inside = {op: fwd.inside.get(op, 0) for op in (conv, attn, gelu)}
    assert inside[attn] == fwd.counts[attn] == 2 * CFG.t_layers
    assert inside[gelu] == fwd.counts[gelu] and 50 < inside[conv] < fwd.counts[conv]
    again = {op: bwd.counts.get(op, 0) for op in (conv, attn, gelu)}
    if policy == "none":
        assert inside[conv] - len(model.remat_blocks()) <= again[conv] <= inside[conv]
        again[conv] = inside[conv]
    want = {None: {conv: 0, attn: 0, gelu: 0},
            "dots": {conv: 0, attn: 0, gelu: inside[gelu]},
            "dots_nb": {conv: 0, attn: inside[attn], gelu: inside[gelu]},
            "none": inside}[policy]
    assert again == want


def test_train_step_rejects_an_unknown_policy(tiny):
    with pytest.raises(ValueError, match="remat_policy"):
        TrainStep(build_model(CFG, from_jax_params(tiny[0]), "cpu", train=True),
                  remat=True, remat_policy="all")


# --- bf16 compute ------------------------------------------------------------------

def _median_rel(grads, ref, f32):
    """The median over the tensors of |grads - ref| / |f32| (norms)."""
    rels = [np.linalg.norm(np.asarray(grads[n], np.float32) - ref[n]) / np.linalg.norm(f)
            for n, f in f32.items() if np.linalg.norm(f) > 1e-6]
    return float(np.median(rels))


def test_bf16_compute_gradients(tiny, jax_remat, jax_bf16):
    """compute_dtype=bf16: the network runs in bf16 (the attention's
    forward op on bf16 operands), the gradients come back f32 to the f32
    parameters, and they track the f32 ones and the JAX package's bf16
    ones (module docstring)."""
    with _CountOps() as ops:
        loss, grads = _port(tiny, compute_dtype=torch.bfloat16)
    assert ops.counts.get(_flash_mha_fwd_op, 0) == 2 * CFG.t_layers
    grads = {n: g.numpy() for n, g in grads.items()}
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in grads.values())
    (jloss, f32), (bloss, bf16) = jax_remat, jax_bf16
    assert abs(loss.item() - jloss) <= 1e-4 * jloss and abs(loss.item() - bloss) <= 1e-4 * jloss
    ours = _median_rel(grads, f32, f32)
    theirs = _median_rel(bf16, f32, f32)
    assert ours < BF16_MEDIAN_JAX and ours < BF16_MEDIAN, ours
    assert _median_rel(grads, bf16, f32) <= 2 * theirs, (_median_rel(grads, bf16, f32), theirs)


def test_bf16_compute_runs_the_bf16_forms(tiny):
    """Under bf16 compute the attention's forward op (K2) sees bf16 q, k,
    v and its backward op (K3) bf16 q, k, v, o and dout beside the f32
    logsumexp, and the master weights, their gradients and Adam's moments
    stay f32."""
    flat, mix, refs = tiny
    step = TrainStep(build_model(CFG, from_jax_params(flat), "cpu", train=True),
                     compute_dtype=torch.bfloat16)
    with _CountOps() as ops:
        loss = step(torch.from_numpy(mix), torch.from_numpy(refs))
    bf16, f32 = torch.bfloat16, torch.float32
    want = {_flash_mha_fwd_op: (bf16,) * 3, _flash_mha_bwd_op: (bf16,) * 4 + (f32, bf16)}
    for op, dtypes in want.items():
        assert ops.dtypes.get(op) == [dtypes] * (2 * CFG.t_layers), (op, ops.dtypes.get(op))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    p = next(step.model.parameters())
    assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert step.optimizer.state[p]["exp_avg"].dtype == torch.float32


# --- K steps per call --------------------------------------------------------------

def _stacked(tiny):
    rng = np.random.default_rng(9)
    _, mix, refs = tiny
    mixes = (rng.standard_normal((K,) + mix.shape) * 0.1).astype(np.float32)
    refss = (rng.standard_normal((K,) + refs.shape) * 0.05).astype(np.float32)
    return torch.from_numpy(mixes), torch.from_numpy(refss)


def test_steps_per_call_equals_single_steps(tiny):
    """TrainStep.steps on K stacked batches is K calls, bit for bit
    (losses, parameters, EMA), and so is augmented_steps K augmented_steps."""
    flat = tiny[0]
    mixes, refss = _stacked(tiny)

    def fresh():
        return TrainStep(build_model(CFG, from_jax_params(flat), "cpu", train=True),
                         lr=1e-3, ema_decay=0.9)

    multi, single = fresh(), fresh()
    losses = multi.steps(mixes, refss)
    assert losses.shape == (K,) and multi.step_count == K
    assert torch.equal(losses, torch.stack([single(m, r) for m, r in zip(mixes, refss)]))
    for (name, a), b in zip(multi.model.named_parameters(), single.model.parameters()):
        assert torch.equal(a, b) and torch.equal(multi.ema[name], single.ema[name]), name

    stems = refss[:2]
    gen = torch.Generator().manual_seed(3)
    augs = [draw_augmentation(stems.shape[1:], gen) for _ in range(2)]
    multi, single = fresh(), fresh()
    losses = augmented_steps(multi, stems, augs)
    assert torch.equal(losses, torch.stack([augmented_step(single, s, a)
                                            for s, a in zip(stems, augs)]))
    for a, b in zip(multi.model.parameters(), single.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="augmentations"):
        augmented_steps(multi, stems, augs[:1])


def test_steps_per_call_matches_jax_multi_step(tiny):
    """K steps per call against make_multi_train_step (lax.scan) under
    SGD, at the tolerances tests/test_train.py holds that scan to K
    single steps."""
    flat = tiny[0]
    mixes, refss = _stacked(tiny)
    init_fn, step_fn = make_multi_train_step(JCFG, optax.sgd(1e-2))
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(flat))
    p, _, jlosses = step_fn(p, init_fn(p), jnp.asarray(mixes.numpy()),
                            jnp.asarray(refss.numpy()))
    step = TrainStep(build_model(CFG, from_jax_params(flat), "cpu", train=True))
    step.optimizer = torch.optim.SGD(step.model.parameters(), lr=1e-2)
    losses = step.steps(mixes, refss)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=2e-6)
    ref = {k: np.asarray(v) for k, v in JP.flatten_tree(p).items()}
    for name, q in step.model.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), ref[name], atol=1e-5, err_msg=name)


# --- the CLI -------------------------------------------------------------------------

def _cli(*args):
    return train_main(["--synthetic", "--test-tiny", "--device", "cpu", "--batch", "1",
                       "--segment-samples", str(SEG), "--log-every", "1", *args])


def test_train_cli_steps_per_call_equals_single_steps(tmp_path, capsys):
    """--steps-per-call 2 draws the same batches and augmentations in the
    same order as --steps-per-call 1: after 4 steps the checkpoints are
    equal bit for bit. It logs and saves at multiples of K."""
    assert _cli("--steps", "4", "--ckpt", str(tmp_path / "k1"), "--save-every", "2") == 0
    capsys.readouterr()
    assert _cli("--steps", "4", "--ckpt", str(tmp_path / "k2"), "--save-every", "2",
                "--steps-per-call", "2") == 0
    err = capsys.readouterr().err
    assert "step 2/4" in err and "step 4/4" in err and "step 1/4" not in err
    assert "checkpointed at step 2" in err
    a, b = (torch.load(tmp_path / k, weights_only=True) for k in ("k1", "k2"))
    assert a["step"] == b["step"] == 4
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
    with pytest.raises(SystemExit):  # 5 - 4 resumed steps do not divide by 2
        _cli("--steps", "5", "--ckpt", str(tmp_path / "k2"), "--resume",
             "--steps-per-call", "2")


@pytest.mark.parametrize("flags", [["--remat"], ["--remat", "--remat-policy", "none"],
                                   ["--remat", "--remat-policy", "dots_nb"],
                                   ["--bf16-compute"]],
                         ids=["remat-dots", "remat-none", "remat-dots_nb", "bf16-compute"])
def test_train_cli_modes(flags, capsys):
    assert _cli("--steps", "1", *flags) == 0
    assert "done: final loss" in capsys.readouterr().out


def test_bench_train(capsys, monkeypatch):
    """The training sweep: one JSON line per configuration, on the CPU
    when asked (full-width htdemucs-4s, 8192 samples); by default on the
    card, so without a GPU it raises."""
    import json

    from demucs_tpu_torch.tools import bench_train

    assert bench_train.main(["--device", "cpu", "--segment-samples", str(SEG), "--batches",
                             "1", "--iters", "1", "--remat", "off", "none",
                             "--steps-per-call", "2"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["remat"], r["steps_per_call"]) for r in recs] == [("off", 2), ("none", 2)]
    assert all(r["device"] == "cpu" and r["step_s"] > 0 for r in recs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench_train.main([])


def test_bench_train_profile_lists_the_largest_ops():
    """`--top`'s profile of one call: the device time and events (none on
    the CPU, so no busy share) and the largest host ops, largest first."""
    from demucs_tpu_torch.tools.bench_train import _profiled

    x = torch.ones(64, 64)
    rec = _profiled(lambda: (x @ x).sum().item(), top=2)
    assert rec["busy_share"] is None and rec["device_s"] == 0 and rec["device_events"] == 0
    assert rec["top_kernels"] == [] and len(rec["top_host_ops"]) == 2
    (name, ms, calls), (_, ms2, _) = rec["top_host_ops"]
    assert isinstance(name, str) and ms >= ms2 >= 0 and calls >= 1
    assert rec["profile_wall_s"] > 0

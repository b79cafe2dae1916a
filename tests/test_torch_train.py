"""demucs_tpu_torch's training path against demucs_tpu's on the CPU.

The tiny htdemucs-4s of tests/test_train.py (channels 8, bottom 32,
3 transformer layers, 8192 samples) on the same weights (init_flat,
carried over by from_jax_params) and the same numpy batch. The JAX
reference is built once per module.

Tolerances, all float32 on the CPU, where the two packages differ only
in the order of sums:
  * loss: 1e-5 relative;
  * each parameter's gradient: max|diff| <= 3e-4 x max|JAX gradient| of
    that parameter. The backward sums over one more axis than the
    forward (whose outputs agree to 1e-5 of scale), and the bias
    gradients of the DConv convs are sums over time that mostly cancel:
    the worst measured is 9.7e-5, tdecoder.2.dconv.layers.0.0.bias;
  * parameters and EMA after 2 Adam steps: rtol 2e-4, atol 2e-5, the
    tolerance tests/test_train.py holds the sharded step to.
Each DConv branch has a GroupNorm(1) right after each of its two
convolutions, which removes any constant shift of the conv's output: the
component of those conv biases' gradients along (1, ..., 1) is exactly
zero, and both packages compute it as a rounding residue (up to 1.5e-4
of the model's largest gradient entry, where the compress conv has one
channel). That component is held to 1e-3 of the largest entry, the rest
of the bias gradient to the 3e-4 above. Adam's update is about
lr x sign(grad) whatever the gradient's size, so the one-channel biases,
whose whole gradient is that residue, are held to 2 lr per step.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.params.ggml import load_model_params as jax_load_model_params
from demucs_tpu.params.ggml import write_ggml as jax_write_ggml
from demucs_tpu.train import make_train_step

from demucs_tpu_torch import audio
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_htdemucs, feeds_group_norm
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.tools.train_cli import main as train_main
from demucs_tpu_torch.train import TrainStep, l1_loss, load_train_state, save_train_state
from demucs_tpu_torch.utils.device import deterministic_cudnn

from _torch_threads import _one_torch_thread  # noqa: F401

TINY = dict(channels=8, bottom_channels=32, t_layers=3)
SEG = 8192
LR = 1e-3
EMA = 0.9
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
ZERO_GRAD = 1e-3   # of the largest gradient entry: a rounding residue


@pytest.fixture(scope="module")
def tiny():
    """(torch cfg, flat numpy weights, mix, refs), as tests/test_train.py."""
    jcfg = dataclasses.replace(J4S, **TINY)
    flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=0)
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, SEG)) * 0.1).astype(np.float32)
    refs = (rng.standard_normal((2, jcfg.num_sources, 2, SEG)) * 0.05).astype(np.float32)
    return dataclasses.replace(HTDEMUCS_4S, **TINY), flat, mix, refs


def _recording_adam(lr):
    """optax.adam, with the raw gradients of the last step kept in the
    optimizer state: one compiled make_train_step then yields the loss
    and gradients (its jax.value_and_grad of l1_loss) and the updates."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, optax.adam(lr))


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """The JAX package's first-step loss and gradients, and its
    parameters and EMA after 2 Adam steps, as flat numpy dicts."""
    _, flat, mix, refs = tiny
    jcfg = dataclasses.replace(J4S, **TINY)
    mix_j, refs_j = jnp.asarray(mix), jnp.asarray(refs)
    init_fn, step_fn = make_train_step(jcfg, _recording_adam(LR), ema_decay=EMA)
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(flat))
    state = init_fn(p)
    flat_np = lambda tree: {k: np.asarray(v) for k, v in JP.flatten_tree(tree).items()}  # noqa: E731
    p, state, loss = step_fn(p, state, mix_j, refs_j)
    grads = flat_np(state[0][0])  # copied out before the next step donates it
    p, state, _ = step_fn(p, state, mix_j, refs_j)
    top = max(np.abs(g).max() for g in grads.values())
    zero = {n for n, g in grads.items() if feeds_group_norm(n) and g.size == 1}
    assert len(zero) == 8 and all(np.abs(grads[n]).max() < ZERO_GRAD * top for n in zero)
    return dict(loss=float(loss), grads=grads, top=top, zero=zero,
                params=flat_np(p), ema=flat_np(state[1]))


def _model(tiny):
    cfg, flat, _, _ = tiny
    return build_htdemucs(cfg, from_jax_params(flat), "cpu", train=True)


def _batch(tiny):
    _, _, mix, refs = tiny
    return torch.from_numpy(mix), torch.from_numpy(refs)


def _params_close(ours: dict, ref: dict, jax_ref: dict, what: str) -> None:
    assert set(ours) == set(ref), what
    for name, r in ref.items():
        o = ours[name].detach().numpy()
        if name in jax_ref["zero"]:
            assert np.abs(o - r).max() <= 2 * 2 * LR, (what, name)
        else:
            np.testing.assert_allclose(o, r, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{what} {name}")


def test_loss_and_gradients_match_jax(tiny, jax_ref):
    model = _model(tiny)
    loss = l1_loss(model, *_batch(tiny))
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - jax_ref["loss"]) <= LOSS_RTOL * abs(jax_ref["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(jax_ref["grads"])
    for name, ref in jax_ref["grads"].items():
        assert grads[name] is not None, name
        ours = grads[name].numpy()
        if feeds_group_norm(name):
            for g in (ours, ref):
                assert abs(g.mean()) <= ZERO_GRAD * jax_ref["top"], (name, g.mean())
            ours, ref = ours - ours.mean(), ref - ref.mean()
        err = np.abs(ours - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("ema", [None, EMA], ids=["plain", "ema"])
def test_two_adam_steps_match_jax(tiny, jax_ref, ema):
    """TrainStep (torch.optim.Adam at optax.adam's defaults, EMA
    e <- e d + p (1 - d)) against make_train_step; the parameters do not
    depend on the EMA, the EMA is held to the JAX EMA."""
    model = _model(tiny)
    step = TrainStep(model, lr=LR, ema_decay=ema)
    for _ in range(2):
        loss = step(*_batch(tiny))
        assert loss.shape == () and math.isfinite(loss.item())
    assert step.step_count == 2
    _params_close(dict(model.named_parameters()), jax_ref["params"], jax_ref, "params")
    if ema is None:
        assert step.ema is None
    else:
        _params_close(step.ema, jax_ref["ema"], jax_ref, "ema")
        assert step.export_weights() is not None


def test_ema_starts_as_a_copy(tiny):
    """The EMA is a real copy: updating the parameters leaves it behind."""
    model = _model(tiny)
    step = TrainStep(model, lr=LR, ema_decay=0.5)
    name, p = next(iter(model.named_parameters()))
    assert step.ema[name].data_ptr() != p.data_ptr()
    before = step.ema[name].clone()
    step(*_batch(tiny))
    moved = (p.detach() - before).abs() > 1e-7
    assert moved.any()
    # one update at d = 0.5 puts the EMA halfway between the start and p
    torch.testing.assert_close(step.ema[name], 0.5 * before + 0.5 * p.detach(),
                               rtol=0, atol=1e-7)


def test_resume_keeps_the_callers_learning_rate(tiny, tmp_path):
    """The optimizer state comes back, the learning rate is the new
    run's (the JAX package's optimizer state does not hold it)."""
    first = TrainStep(_model(tiny), lr=LR)
    first(*_batch(tiny))
    save_train_state(tmp_path / "ckpt", first)
    resumed = TrainStep(_model(tiny), lr=LR / 4)
    load_train_state(tmp_path / "ckpt", resumed)
    assert [g["lr"] for g in resumed.optimizer.param_groups] == [LR / 4]
    state = resumed.optimizer.state[next(resumed.model.parameters())]
    assert int(state["step"]) == 1 and state["exp_avg"].abs().max() > 0


def test_load_rejects_another_model(tiny, tmp_path):
    step = TrainStep(_model(tiny), lr=LR)
    save_train_state(tmp_path / "ckpt", step)
    cfg = dataclasses.replace(HTDEMUCS_4S, channels=8, bottom_channels=32, t_layers=2)
    from demucs_tpu_torch.params import from_state_dict, htdemucs_schema, init_flat
    schema = htdemucs_schema(cfg)
    other = build_htdemucs(cfg, from_state_dict(init_flat(schema), schema), "cpu", train=True)
    with pytest.raises(ValueError, match="do not match"):
        load_train_state(tmp_path / "ckpt", TrainStep(other))


def test_trainable_model_owns_its_weights(tiny):
    """build_htdemucs(train=True): train mode, every parameter requires
    grad, and the optimizer's in-place updates do not reach the caller's
    state dict."""
    cfg, flat, _, _ = tiny
    sd = from_jax_params(flat)
    model = build_htdemucs(cfg, sd, "cpu", train=True)
    assert model.training and all(p.requires_grad for p in model.parameters())
    name, p = next(iter(model.named_parameters()))
    with torch.no_grad():
        p.add_(1.0)
    assert not torch.equal(p.detach(), sd[name])
    assert not build_htdemucs(cfg, sd, "cpu").training


def test_l1_loss_rejects_batch_mismatch(tiny):
    mix, refs = _batch(tiny)
    with pytest.raises(ValueError, match="batch"):
        l1_loss(_model(tiny), mix[:1], refs)


def test_tf32_stays_off_through_backward(tiny):
    """The step's f32 scope covers backward() and the optimizer: the
    model's inner f32_precision() restores only what it changed, so it
    cannot turn TF32 back on before autograd runs the backward."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    seen = []
    try:
        for f in flags:
            f.allow_tf32 = True
        model = _model(tiny)
        for p in model.parameters():
            p.register_hook(lambda g: seen.append([f.allow_tf32 for f in flags]) or g)
        TrainStep(model, lr=LR)(*_batch(tiny))
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
    assert len(seen) == len(list(model.parameters()))
    assert all(s == [False, False] for s in seen)
    assert after == [True, True]


@pytest.mark.parametrize("deterministic,benchmark", [(False, True), (True, False),
                                                     (False, False), (True, True)])
def test_deterministic_cudnn_scope_restores_what_it_changed(deterministic, benchmark):
    """deterministic_cudnn() turns cuDNN's `deterministic` on and
    `benchmark` off inside the block, and afterwards each flag is what it
    was before, whether the block changed it or not."""
    flags = torch.backends.cudnn
    before = (flags.deterministic, flags.benchmark)
    try:
        flags.deterministic, flags.benchmark = deterministic, benchmark
        with deterministic_cudnn():
            assert (flags.deterministic, flags.benchmark) == (True, False)
        assert (flags.deterministic, flags.benchmark) == (deterministic, benchmark)
    finally:
        flags.deterministic, flags.benchmark = before


def test_deterministic_cudnn_holds_through_backward(tiny):
    """TrainStep holds deterministic_cudnn() over the forward, backward()
    and the optimizer, beside f32_precision(), and restores both flags."""
    flags = torch.backends.cudnn
    before = (flags.deterministic, flags.benchmark)
    seen = []
    try:
        flags.deterministic, flags.benchmark = False, True
        model = _model(tiny)
        for p in model.parameters():
            p.register_hook(
                lambda g: seen.append((flags.deterministic, flags.benchmark)) or g)
        TrainStep(model, lr=LR)(*_batch(tiny))
        after = (flags.deterministic, flags.benchmark)
    finally:
        flags.deterministic, flags.benchmark = before
    assert len(seen) == len(list(model.parameters()))
    assert all(s == (True, False) for s in seen)
    assert after == (False, True)


# --- the training CLI ------------------------------------------------------

def _cli(*args):
    return train_main(["--synthetic", "--device", "cpu", "--batch", "1",
                       "--segment-samples", str(SEG), "--log-every", "1", *args])


def test_train_cli_tiny_synthetic(capsys):
    assert _cli("--test-tiny", "--steps", "2") == 0
    out = capsys.readouterr()
    assert "step 1/2" in out.err and "step 2/2" in out.err
    assert "loss" in out.err and "step_s" in out.err
    assert "done: final loss" in out.out


def test_train_cli_musdb_layout_dir(tmp_path, capsys):
    """--data over a MUSDB-layout directory the test writes."""
    rng = np.random.default_rng(8)
    for track in ("track01", "track02"):
        d = tmp_path / "train" / track
        d.mkdir(parents=True)
        for stem in HTDEMUCS_4S.sources:
            audio.write_wav(d / f"{stem}.wav",
                            (rng.standard_normal((2, 12000)) * 0.1).astype(np.float32))
    rc = train_main(["--data", str(tmp_path / "train"), "--test-tiny", "--device", "cpu",
                     "--steps", "1", "--batch", "2", "--segment-samples", str(SEG)])
    assert rc == 0
    out = capsys.readouterr()
    assert "loaded 2 tracks" in out.err and "done: final loss" in out.out


def test_train_cli_resume_and_export_ggml(tmp_path, capsys):
    """Full width at a short segment: start from a ggml file the JAX
    package wrote, train with EMA and checkpoints, resume, export; the
    exported file loads in demucs_tpu.params.load_model_params and holds
    the checkpoint's EMA weights (to the container's fp16)."""
    flat = JP.init_flat(JP.htdemucs_schema(J4S), seed=7)
    base = tmp_path / "base.bin"
    jax_write_ggml(base, "htdemucs_4s", flat)
    ck, out = tmp_path / "ck", tmp_path / "trained.bin"
    common = ["--init-from", str(base), "--ema", "0.9", "--ckpt", str(ck)]
    assert _cli(*common, "--steps", "2", "--save-every", "1") == 0
    err = capsys.readouterr().err
    assert "initialized from" in err and "checkpointed at step 1" in err
    assert _cli(*common, "--steps", "3", "--resume", "--export-ggml", str(out)) == 0
    err = capsys.readouterr().err
    assert "resumed at step 2" in err and "step 3/3" in err
    assert "exported EMA weights" in err

    cfg, tree = jax_load_model_params(out)
    assert cfg.num_sources == 4
    exported = JP.flatten_tree(tree)
    state = torch.load(ck, weights_only=True)
    assert state["step"] == 3
    assert set(exported) == set(state["ema"])
    for name, e in state["ema"].items():
        np.testing.assert_array_equal(
            np.asarray(exported[name]).reshape(e.shape),
            e.numpy().astype(np.float16).astype(np.float32), err_msg=name)
    moved = np.abs(state["params"]["encoder.0.conv.weight"].numpy()
                   - flat["encoder.0.conv.weight"]).max()
    assert 0 < moved < 0.05


def test_train_cli_resume_past_the_end_leaves_the_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert _cli("--test-tiny", "--steps", "1", "--ckpt", str(ck)) == 0
    mtime = ck.stat().st_mtime_ns
    assert _cli("--test-tiny", "--steps", "1", "--ckpt", str(ck), "--resume") == 0
    assert "nothing to do" in capsys.readouterr().err
    assert ck.stat().st_mtime_ns == mtime


def test_train_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        train_main(["--synthetic", "--test-tiny", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    [], ["--synthetic", "--data", "x"], ["--synthetic", "--resume"],
    ["--synthetic", "--steps", "-1"], ["--synthetic", "--steps-per-call", "0"],
    ["--synthetic", "--steps-per-call", "2", "--save-every", "3"],
    ["--data", "x", "--eval-every", "2"],
    ["--synthetic", "--test-tiny", "--family", "hdemucs_v3"],
], ids=["no-data", "both-data", "resume-no-ckpt", "negative-steps", "steps-per-call-0",
        "save-every-not-a-multiple", "eval-without-data", "test-tiny-v3"])
def test_train_cli_rejects(argv):
    """Bad combinations, as the JAX CLI refuses them."""
    with pytest.raises(SystemExit):
        train_main(argv + ["--device", "cpu"])

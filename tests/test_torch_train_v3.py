"""hdemucs_mmi (v3) training in demucs_tpu_torch against demucs_tpu on the CPU.

K6 and K4 train through autograd Functions whose backward recomputes the
plain twin (`ops.BiLSTMRecurrence`, `ops.GnGluScaleRes`); their
gradients, a whole encoder-4 DConv's and the full-width model's loss,
gradients and one Adam step are held against the JAX package on the
same numpy inputs and `init_flat` weights. The JAX train step is
compiled once for the module.

Tolerances, f32 on the CPU unless stated:
  * the recurrence (T = 37, B = 2, H = 16): ys to 2e-6 absolute (h lies in
    (-1, 1)) and each gradient to 1e-5 of its largest entry, against the
    Pallas kernel in interpret mode and against the scan (JAX's backward
    recomputes through the scan in both). In bf16 the JAX scan runs every
    op in bf16 while the port's twin keeps the gates and c in f32 and
    rounds h (the kernels' arithmetic), so each is held to the f32
    result: the port's ys and gradients to 2e-2 and 5e-2 of the largest
    entry, the JAX package's to its own measured error;
  * the DConv tail (K4's Function) and the encoder-4 DConv: 1e-5 of the
    largest entry of each gradient;
  * the full-width model at 8192 samples, batch 1: the loss to 1e-5
    relative, each gradient as tests/test_torch_train.py holds v4's (3e-4
    of its largest entry; the GroupNorm-removed mean of the DConv conv
    biases' gradients to 1e-3 of the largest entry of all). LocalState's
    key biases add q.b to every logit of a query, which its softmax over
    the keys removes: their gradient is zero up to rounding in both
    packages (measured up to 2e-12 of the largest entry) and is held to
    1e-9 of the largest entry. The parameters after one Adam step: rtol 2e-4,
    atol 2e-5, and those zero-gradient tensors, whose Adam update is about
    lr x sign(rounding residue), to 2 lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu import params as JP
from demucs_tpu.config import HDEMUCS_V3 as JV3
from demucs_tpu.models.hdemucs_v3 import dconv_lstm_attn
from demucs_tpu.models.htdemucs import dconv_tail as jax_dconv_tail
from demucs_tpu.ops import lstm as JLSTM
from demucs_tpu.ops.pallas import attention as JPA
from demucs_tpu.train import make_train_step

from demucs_tpu_torch import ops as TO
from demucs_tpu_torch.config import HDEMUCS_V3
from demucs_tpu_torch.models import build_hdemucs_v3, build_model, feeds_group_norm
from demucs_tpu_torch.ops.cuda import bilstm_recurrence, gn_glu_scale_res
from demucs_tpu_torch.params import from_jax_params, quantize_int8
from demucs_tpu_torch.tools.train_cli import main as train_main
from demucs_tpu_torch.train import TrainStep

from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 8192
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
ZERO_GRAD = 1e-3        # the GroupNorm-removed bias means, of the largest entry
KEY_BIAS_ZERO = 1e-9    # LocalState's key biases, of the largest entry


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(out, ref):
    """max|out - ref| over max|ref|, in f32 (out a tensor or an array)."""
    if isinstance(out, torch.Tensor):
        out = out.detach().float().numpy()
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# --- K6 under autograd -------------------------------------------------------------

def _jax_recurrence_vjp(xs, w_hh, g, dtype, pallas):
    """ys and the (xs, w_hh) gradients of demucs_tpu.ops.lstm._recurrence,
    whose forward is the Pallas kernel (interpret mode) or the scan, and
    whose backward recomputes through the scan."""
    old = JLSTM.USE_PALLAS, JPA.INTERPRET
    try:
        JLSTM.USE_PALLAS, JPA.INTERPRET = pallas, True
        ys, vjp = jax.vjp(JLSTM._recurrence, jnp.asarray(xs, dtype), jnp.asarray(w_hh, dtype))
        dxs, dw = vjp(jnp.asarray(g, dtype))
    finally:
        JLSTM.USE_PALLAS, JPA.INTERPRET = old
    return [np.asarray(a, np.float32) for a in (ys, dxs, dw)]


def _port_recurrence_vjp(xs, w_hh, g, dtype):
    xs_t = torch.from_numpy(xs).to(dtype).requires_grad_()
    w_t = torch.from_numpy(w_hh).to(dtype).requires_grad_()
    before = bilstm_recurrence.launches
    ys = TO.BiLSTMRecurrence.apply(xs_t, w_t)
    ys.backward(torch.from_numpy(g).to(dtype))
    assert bilstm_recurrence.launches == before  # the twin on CPU tensors
    assert xs_t.grad.dtype == dtype and w_t.grad.dtype == dtype
    return [t.detach().float().numpy() for t in (ys, xs_t.grad, w_t.grad)]


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "scan"])
def test_bilstm_recurrence_function_gradients_f32(pallas):
    T, B, H = 37, 2, 16
    xs, w_hh = _rand(T, 2, B, 4 * H, seed=1), _rand(2, H, 4 * H, seed=2, scale=0.2)
    g = _rand(T, 2, B, H, seed=3)
    ours = _port_recurrence_vjp(xs, w_hh, g, torch.float32)
    ref = _jax_recurrence_vjp(xs, w_hh, g, jnp.float32, pallas)
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-6)
    for name, o, r in zip(("dxs", "dw_hh"), ours[1:], ref[1:]):
        assert _rel(o, r) <= 1e-5, (name, _rel(o, r))


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "scan"])
def test_bilstm_recurrence_function_gradients_bf16(pallas):
    T, B, H = 37, 2, 16
    xs, w_hh = _rand(T, 2, B, 4 * H, seed=1), _rand(2, H, 4 * H, seed=2, scale=0.2)
    # bf16 inputs: both packages and the f32 reference start from the same values
    xs, w_hh = (torch.from_numpy(a).bfloat16().float().numpy() for a in (xs, w_hh))
    g = torch.from_numpy(_rand(T, 2, B, H, seed=3)).bfloat16().float().numpy()
    f32 = _jax_recurrence_vjp(xs, w_hh, g, jnp.float32, False)
    ours = _port_recurrence_vjp(xs, w_hh, g, torch.bfloat16)
    ref = _jax_recurrence_vjp(xs, w_hh, g, jnp.bfloat16, pallas)
    for name, o, r, f, tol in zip(("ys", "dxs", "dw_hh"), ours, ref, f32, (2e-2, 5e-2, 5e-2)):
        assert np.isfinite(o).all(), name
        assert _rel(o, f) <= tol, (name, _rel(o, f))
        # no further from f32 than the JAX package's bf16 form, with room
        assert _rel(o, f) <= 2 * _rel(r, f) + 1e-2, (name, _rel(o, f), _rel(r, f))


def test_bilstm_layer_uses_the_function_in_grad_mode():
    """In grad mode `ops.bilstm` differentiates through BiLSTMRecurrence
    (the result carries its backward), without grad it calls the kernel's
    wrapper directly."""
    x = torch.from_numpy(_rand(2, 9, 8, seed=4))
    layers = [{d: {k: torch.from_numpy(_rand(*s, seed=5 + i)).requires_grad_()
                   for i, (k, s) in enumerate((("weight_ih", (16, 8)), ("weight_hh", (16, 4)),
                                               ("bias_ih", (16,)), ("bias_hh", (16,))))}
               for d in ("forward", "reverse")}]
    y = TO.bilstm(x, layers)
    assert y.shape == (2, 9, 8) and y.requires_grad
    names = set()
    stack = [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert "BiLSTMRecurrenceBackward" in names
    with torch.no_grad():
        torch.testing.assert_close(TO.bilstm(x, layers), y.detach(), rtol=0, atol=0)


# --- K4 under autograd -------------------------------------------------------------

def test_gn_glu_scale_res_function_gradients():
    """GnGluScaleRes against jax.grad of the v3 DConv tail
    (models/htdemucs.py:dconv_tail, the XLA form the JAX package trains)."""
    R, C, T = 2, 24, 40
    y, res = _rand(R, 2 * C, T, seed=6), _rand(R, C, T, seed=7)
    w, b = 1 + _rand(2 * C, seed=8, scale=0.1), _rand(2 * C, seed=9, scale=0.1)
    scale, cot = _rand(C, seed=10, scale=0.1), _rand(R, C, T, seed=11)

    def jax_tail(y, w, b, scale, res):
        out = jax_dconv_tail(y, {"weight": w, "bias": b}, {"scale": scale}, res)
        return jnp.sum(out * cot)

    ref = jax.grad(jax_tail, argnums=tuple(range(5)))(*map(jnp.asarray, (y, w, b, scale, res)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (y, w, b, scale, res)]
    before = gn_glu_scale_res.launches
    out = TO.gn_glu_scale_res(*ts)
    assert "GnGluScaleResBackward" in type(out.grad_fn).__name__
    (out * torch.from_numpy(cot)).sum().backward()
    assert gn_glu_scale_res.launches == before
    for name, t, r in zip(("y", "weight", "bias", "scale", "res"), ts, ref):
        assert _rel(t.grad, r) <= 1e-5, (name, _rel(t.grad, r))


# --- a v3 encoder-4 DConv and the whole model ---------------------------------------

@pytest.fixture(scope="module")
def v3_flat():
    return JP.init_flat(JP.hdemucs_v3_schema(JV3), seed=0)


def test_encoder4_dconv_gradients_match_jax(v3_flat):
    """The encoder-4 DConv (2 sub-blocks: conv, GroupNorm, GELU, 2-layer
    BiLSTM of H = 192, linear, LocalState, conv, the tail) at its true
    widths (768 channels) and T = 12: the input's and every weight's
    gradient against jax.grad of dconv_lstm_attn."""
    tree = jax.tree.map(jnp.asarray, JP.unflatten_tree(v3_flat))
    blocks = tree["encoder"][4]["dconv"]["layers"]
    x, cot = _rand(1, 768, 12, seed=12), _rand(1, 768, 12, seed=13)

    def loss(x, blocks):
        return jnp.sum(dconv_lstm_attn(x, blocks) * cot)

    gx, gblocks = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), blocks)
    ref = {f"encoder.4.dconv.layers.{k}": np.asarray(v)
           for k, v in JP.flatten_tree(gblocks).items()}
    model = build_hdemucs_v3(HDEMUCS_V3, from_jax_params(v3_flat), "cpu", train=True)
    xt = torch.from_numpy(x).requires_grad_()
    (model.encoder[4].dconv(xt) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, gx) <= 1e-5
    grads = {n: p.grad for n, p in model.named_parameters() if n.startswith("encoder.4.dconv.")}
    assert set(grads) == set(ref) and len(ref) == 2 * 37  # 18 BiLSTM, 10 LocalState, 9 others
    top = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        if name.endswith("4.key.bias"):
            assert np.abs(grads[name].numpy()).max() <= KEY_BIAS_ZERO * top, name
            continue
        assert _rel(grads[name], r) <= 1e-5, (name, _rel(grads[name], r))


def _recording_adam(lr):
    """optax.adam, with the raw gradients of the last step kept in the
    optimizer state (as tests/test_torch_train.py)."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, optax.adam(lr))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((1, 2, SEG)) * 0.1).astype(np.float32)
    refs = (rng.standard_normal((1, 4, 2, SEG)) * 0.05).astype(np.float32)
    return mix, refs


@pytest.fixture(scope="module")
def jax_ref(v3_flat, batch):
    """make_train_step(HDEMUCS_V3)'s first step: its loss, gradients and
    parameters after one Adam step, as flat numpy dicts."""
    init_fn, step_fn = make_train_step(JV3, _recording_adam(LR))
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(v3_flat))
    p, state, loss = step_fn(p, init_fn(p), *map(jnp.asarray, batch))
    flat_np = lambda tree: {k: np.asarray(v) for k, v in JP.flatten_tree(tree).items()}  # noqa: E731
    grads = flat_np(state[0])
    return dict(loss=float(loss), grads=grads, params=flat_np(p),
                top=max(np.abs(g).max() for g in grads.values()))


def test_v3_loss_gradients_and_adam_step_match_jax(v3_flat, batch, jax_ref):
    model = build_model(HDEMUCS_V3, from_jax_params(v3_flat), "cpu", train=True)
    step = TrainStep(model, lr=LR)
    captured = {}
    for n, p in model.named_parameters():
        p.register_hook(lambda g, n=n: captured.__setitem__(n, g.clone()) or g)
    loss = step(*map(torch.from_numpy, batch)).item()
    assert abs(loss - jax_ref["loss"]) <= LOSS_RTOL * abs(jax_ref["loss"])
    assert set(captured) == set(jax_ref["grads"])
    top, zero = jax_ref["top"], set()
    for name, ref in jax_ref["grads"].items():
        ours = captured[name].numpy()
        if name.endswith("4.key.bias"):
            for g in (ours, ref):
                assert np.abs(g).max() <= KEY_BIAS_ZERO * top, name
            zero.add(name)
            continue
        if feeds_group_norm(name):
            for g in (ours, ref):
                assert abs(g.mean()) <= ZERO_GRAD * top, (name, g.mean())
            ours, ref = ours - ours.mean(), ref - ref.mean()
            if ref.size == 1:
                zero.add(name)
                continue
        err = np.abs(ours - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())
    assert len(zero) == 4
    for name, p in model.named_parameters():
        if name in zero:
            assert np.abs(p.detach().numpy() - jax_ref["params"][name]).max() <= 2 * LR, name
        else:
            np.testing.assert_allclose(p.detach().numpy(), jax_ref["params"][name],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)


def test_trainable_v3_owns_its_weights(v3_flat):
    """build_hdemucs_v3(train=True), as build_htdemucs(train=True): train
    mode, every parameter requiring grad, its own copy of the weights; a
    quantized state dict is refused; build_model passes train through."""
    sd = from_jax_params(v3_flat)
    model = build_hdemucs_v3(HDEMUCS_V3, sd, "cpu", train=True)
    assert model.training and all(p.requires_grad for p in model.parameters())
    name, p = next(iter(model.named_parameters()))
    with torch.no_grad():
        p.add_(1.0)
    assert not torch.equal(p.detach(), sd[name])
    assert not build_hdemucs_v3(HDEMUCS_V3, sd, "cpu").training
    assert build_model(HDEMUCS_V3, sd, "cpu", train=True).training
    with pytest.raises(ValueError, match="inference"):
        build_hdemucs_v3(HDEMUCS_V3, quantize_int8(sd), "cpu", train=True)


@pytest.mark.parametrize("name", ["build_model", "build_htdemucs", "build_hdemucs_v3",
                                     "build_bag"])
def test_model_constructors_default_to_cuda(v3_flat, monkeypatch, name):
    """Every build_* function of `models` runs on the card unless asked
    for the CPU: without a GPU, leaving out `device` raises."""
    from demucs_tpu_torch import models
    from demucs_tpu_torch.config import HTDEMUCS_4S
    from demucs_tpu_torch.params import htdemucs_schema, init_flat, from_state_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name in ("build_hdemucs_v3", "build_model"):
        args = (HDEMUCS_V3, from_jax_params(v3_flat))
    else:
        schema = htdemucs_schema(HTDEMUCS_4S)
        sd = from_state_dict(init_flat(schema, seed=0), schema)
        args = (HTDEMUCS_4S, [sd] * 4 if name == "build_bag" else sd)
    with pytest.raises(RuntimeError, match="no GPU"):
        getattr(models, name)(*args)


# --- the training CLI on v3 ------------------------------------------------------------

def _cli(*args):
    return train_main(["--synthetic", "--device", "cpu", "--batch", "1",
                       "--segment-samples", str(SEG), "--log-every", "1", *args])


def test_train_cli_v3_synthetic_two_steps(capsys):
    assert _cli("--family", "hdemucs_v3", "--steps", "2") == 0
    out = capsys.readouterr()
    assert "step 1/2" in out.err and "step 2/2" in out.err
    assert "done: final loss" in out.out


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_v3_remat_equals_no_remat(v3_flat, batch, policy):
    """v3 under remat (encoders 0-3 and the encoder-4/5 DConvs each a
    region): the loss and every gradient bit for bit those without."""
    from demucs_tpu_torch.train import l1_loss

    out = []
    for kw in ({}, dict(remat=True, remat_policy=policy)):
        model = build_model(HDEMUCS_V3, from_jax_params(v3_flat), "cpu", train=True)
        loss = l1_loss(model, *map(torch.from_numpy, batch), **kw)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))

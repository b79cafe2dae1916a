"""demucs_tpu_torch's training step on a tiny htdemucs-6s against
demucs_tpu's make_train_step on the CPU: the loss, every parameter's
gradient and the parameters after one Adam step.

tests/test_torch_train.py holds the 4s model; the 6s model differs in
its six sources and in having no channel up/downsampling around the
transformer (bottom_channels 0: the transformer runs at the last
encoder's width). Same weights (init_flat, carried over by
from_jax_params), same numpy batch, the tolerances of
tests/test_torch_train.py, which says why each is what it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_6S as J6S
from demucs_tpu.train import make_train_step

from demucs_tpu_torch.config import HTDEMUCS_6S
from demucs_tpu_torch.models import build_htdemucs, feeds_group_norm
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.train import TrainStep, l1_loss

from _torch_threads import _one_torch_thread  # noqa: F401

TINY = dict(channels=8, t_layers=3)
SEG = 8192
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 3e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
ZERO_GRAD = 1e-3   # of the largest gradient entry: a rounding residue


@pytest.fixture(scope="module")
def case():
    """Flat weights, the batch, and JAX's loss, gradients and parameters
    after one Adam step, from one compiled make_train_step."""
    jcfg = dataclasses.replace(J6S, **TINY)
    flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=0)
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, SEG)) * 0.1).astype(np.float32)
    refs = (rng.standard_normal((2, jcfg.num_sources, 2, SEG)) * 0.05).astype(np.float32)
    # optax.adam, with the last step's raw gradients kept in its state
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    init_fn, step_fn = make_train_step(jcfg, optax.chain(keep, optax.adam(LR)))
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(flat))
    p, state, loss = step_fn(p, init_fn(p), jnp.asarray(mix), jnp.asarray(refs))
    flat_np = lambda tree: {k: np.asarray(v) for k, v in JP.flatten_tree(tree).items()}  # noqa: E731
    grads = flat_np(state[0])   # the chain's first state: the kept gradients
    return dict(flat=flat, mix=mix, refs=refs, loss=float(loss), grads=grads,
                params=flat_np(p), top=max(np.abs(g).max() for g in grads.values()))


def _model(case):
    cfg = dataclasses.replace(HTDEMUCS_6S, **TINY)
    return build_htdemucs(cfg, from_jax_params(case["flat"]), "cpu", train=True)


def _batch(case):
    return torch.from_numpy(case["mix"]), torch.from_numpy(case["refs"])


def test_6s_loss_and_gradients_match_jax(case):
    model = _model(case)
    assert model.cfg.num_sources == 6 and not model.cfg.bottom_channels
    loss = l1_loss(model, *_batch(case))
    loss.backward()
    assert abs(loss.item() - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(case["grads"])
    for name, ref in case["grads"].items():
        ours = grads[name].numpy()
        if feeds_group_norm(name):
            # the component along (1, ..., 1) is a rounding residue
            for g in (ours, ref):
                assert abs(g.mean()) <= ZERO_GRAD * case["top"], (name, g.mean())
            ours, ref = ours - ours.mean(), ref - ref.mean()
        err = np.abs(ours - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_6s_adam_step_matches_jax(case):
    model = _model(case)
    step = TrainStep(model, lr=LR)
    loss = step(*_batch(case))
    assert abs(loss.item() - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    ours = dict(model.named_parameters())
    assert set(ours) == set(case["params"])
    for name, ref in case["params"].items():
        o = ours[name].detach().numpy()
        if feeds_group_norm(name) and ref.size == 1:
            # a one-channel bias whose whole gradient is the residue:
            # Adam moves it by about lr whatever the residue's sign
            assert np.abs(o - ref).max() <= 2 * LR, name
        else:
            np.testing.assert_allclose(o, ref, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)

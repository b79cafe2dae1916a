"""demucs_tpu_torch.data against demucs_tpu.data on the CPU.

The sampler and the track loader are numpy on both sides and must give
bit-identical arrays. The augmentation draws differ by design (jax.random
keys against torch.Generator), so the test computes the JAX package's
draws from its key exactly as `demucs_tpu.data.augment_stems` does and
feeds them to the port's deterministic `apply_augmentation`: flips, signs
(+-1) and gathers are exact and the gain is one product either way, so
the stems must agree bit for bit. The augmented training step is held
to `make_augmented_train_step` on the tiny htdemucs-4s of
tests/test_train.py with the tolerances of tests/test_torch_train.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demucs_tpu import audio as jaudio
from demucs_tpu import data as JD
from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S

from demucs_tpu_torch import data as TD
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_htdemucs, feeds_group_norm
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.train import TrainStep

from _torch_threads import _one_torch_thread  # noqa: F401

TINY = dict(channels=8, bottom_channels=32, t_layers=3)
SEG = 8192
LR = 1e-3


def _tracks(seed=0, lengths=(5000, 7321, 9000), S=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((S, 2, n)).astype(np.float32) for n in lengths]


def _jax_draws(key, B, S):
    """The draws of demucs_tpu.data.augment_stems (remix on) for `key`,
    as torch."""
    k_flip, k_sign, k_scale, k_remix = jax.random.split(key, 4)
    flip = jax.random.bernoulli(k_flip, 0.5, (B, S))
    sign = jax.random.rademacher(k_sign, (B, S), dtype=jnp.float32)
    scale = jax.random.uniform(k_scale, (B, S), jnp.float32, TD.SCALE_MIN, TD.SCALE_MAX)
    perms = None
    if B > 1:
        perms = torch.from_numpy(np.asarray(jnp.stack(
            [jax.random.permutation(k, B) for k in jax.random.split(k_remix, S)],
            axis=1)).astype(np.int64))
    return TD.Augmentation(*(torch.from_numpy(np.array(x)) for x in (flip, sign, scale)),
                           perms)


# --- host side -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_segment_sampler_bit_identical(seed):
    tracks = _tracks(seed)
    ours = TD.SegmentSampler(tracks, 4096, seed=seed)
    ref = JD.SegmentSampler(tracks, 4096, seed=seed)
    for batch in (4, 1, 3):
        a, b = ours.batch(batch), ref.batch(batch)
        assert a.dtype == np.float32 and a.shape == (batch, 4, 2, 4096)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tracks,segment", [
    ([], 16), (_tracks(lengths=(100,)) + _tracks(lengths=(100,), S=6), 16),
    (_tracks(lengths=(100,)), 101)], ids=["empty", "inconsistent", "short"])
def test_segment_sampler_rejects_like_jax(tracks, segment):
    for cls in (TD.SegmentSampler, JD.SegmentSampler):
        with pytest.raises(ValueError):
            cls(tracks, segment)


def test_load_musdb_track_matches_jax(tmp_path):
    """Stems of unequal length are cut to the shortest, as in the JAX
    package; both read the same WAV files."""
    rng = np.random.default_rng(1)
    for i, stem in enumerate(HTDEMUCS_4S.sources):
        jaudio.write_wav(tmp_path / f"{stem}.wav",
                         (rng.standard_normal((2, 3000 + 10 * i)) * 0.2).astype(np.float32))
    ours = TD.load_musdb_track(tmp_path)
    ref = JD.load_musdb_track(tmp_path)
    assert ours.shape == (4, 2, 3000) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


# --- device side -------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 3, 1], ids=["remix", "remix-odd", "batch1"])
def test_apply_augmentation_matches_jax(B):
    """Remix at B > 1; at B = 1 there is none, on either side."""
    stems = np.random.default_rng(2).standard_normal((B, 4, 2, 257)).astype(np.float32)
    key = jax.random.key(5)
    ref = np.asarray(JD.augment_stems(key, jnp.asarray(stems)))
    draws = _jax_draws(key, B, 4)
    assert (draws.perms is None) == (B == 1)
    ours = TD.apply_augmentation(torch.from_numpy(stems), *draws)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_mix_from_stems_matches_jax():
    stems = np.random.default_rng(3).standard_normal((2, 4, 2, 100)).astype(np.float32)
    ours = TD.mix_from_stems(torch.from_numpy(stems)).numpy()
    ref = np.asarray(JD.mix_from_stems(jnp.asarray(stems)))
    assert ours.shape == (2, 2, 100)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_draws_are_valid_and_follow_the_generator():
    shape = (5, 4, 2, 10)
    a = TD.draw_augmentation(shape, torch.Generator().manual_seed(7))
    b = TD.draw_augmentation(shape, torch.Generator().manual_seed(7))
    c = TD.draw_augmentation(shape, torch.Generator().manual_seed(8))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.scale, c.scale)
    assert a.flip.dtype == torch.bool and set(a.sign.unique().tolist()) <= {-1, 1}
    assert ((a.scale >= TD.SCALE_MIN) & (a.scale < TD.SCALE_MAX)).all()
    assert (a.perms.sort(dim=0).values == torch.arange(5)[:, None]).all()
    assert TD.draw_augmentation((1, 4, 2, 10), torch.Generator()).perms is None


def test_augment_stems_is_draw_then_apply():
    stems = torch.from_numpy(
        np.random.default_rng(4).standard_normal((3, 4, 2, 50)).astype(np.float32))
    out = TD.augment_stems(stems, torch.Generator().manual_seed(9))
    draws = TD.draw_augmentation(stems.shape, torch.Generator().manual_seed(9))
    assert torch.equal(out, TD.apply_augmentation(stems, *draws))
    # every output row is a gained, maybe sign- and channel-flipped, row of
    # the same source in some batch item
    for b in range(3):
        for s in range(4):
            src = stems[draws.perms[b, s], s]
            cand = src.flip(0) if draws.flip[draws.perms[b, s], s] else src
            gain = draws.sign[draws.perms[b, s], s] * draws.scale[draws.perms[b, s], s]
            torch.testing.assert_close(out[b, s], cand * gain, rtol=0, atol=0)


def test_augmented_step_matches_jax():
    """One augmented Adam step on the JAX package's draws against
    make_augmented_train_step with the same key: loss to 1e-5 relative,
    parameters to rtol 2e-4 / atol 2e-5, except the one-channel DConv
    biases whose gradient is a rounding residue (tests/test_torch_train.py),
    held to 2 lr."""
    jcfg = dataclasses.replace(J4S, **TINY)
    flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=0)
    stems = (np.random.default_rng(6).standard_normal((2, 4, 2, SEG)) * 0.05).astype(np.float32)
    key = jax.random.key(11)
    init_fn, step_fn = JD.make_augmented_train_step(jcfg, optax.adam(LR))
    p = jax.tree.map(jnp.asarray, JP.unflatten_tree(flat))
    p, _, loss = step_fn(p, init_fn(p), key, jnp.asarray(stems))
    ref = {k: np.asarray(v) for k, v in JP.flatten_tree(p).items()}

    model = build_htdemucs(dataclasses.replace(HTDEMUCS_4S, **TINY), from_jax_params(flat),
                           "cpu", train=True)
    ours = TD.augmented_step(TrainStep(model, lr=LR), torch.from_numpy(stems),
                             _jax_draws(key, 2, 4))
    assert abs(ours.item() - float(loss)) <= 1e-5 * abs(float(loss))
    for name, w in model.named_parameters():
        w = w.detach().numpy()
        if feeds_group_norm(name) and w.size == 1:
            assert np.abs(w - ref[name]).max() <= 2 * LR, name
        else:
            np.testing.assert_allclose(w, ref[name], rtol=2e-4, atol=2e-5, err_msg=name)

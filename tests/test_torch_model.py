"""demucs_tpu_torch's HTDemucs against demucs_tpu's htdemucs_segment on
the CPU, at full width, on the same weights (init_flat, carried over by
from_jax_params) and the same mix.

Both graphs run in float32 and differ only in the order of sums (FFT,
convolution and matmul algorithms); the tolerance, 1e-5 of the output's
scale, is 30x tighter than the 3e-4 that tests/test_model_v4.py allows
the JAX graph against the torch oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S, HTDEMUCS_6S as J6S
from demucs_tpu.models import htdemucs_segment

from demucs_tpu_torch.config import HTDEMUCS_4S, HTDEMUCS_6S
from demucs_tpu_torch.models import build_htdemucs
from demucs_tpu_torch.params import from_jax_params

SEG = 1024 * 32
TOL = 1e-5


def _compare(jcfg, tcfg, length, batch=1, seed=0):
    flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=seed)
    model = build_htdemucs(tcfg, from_jax_params(flat), "cpu")
    rng = np.random.default_rng(42)
    mix = (rng.standard_normal((batch, 2, length)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(mix)).numpy()
    ref = np.asarray(jax.jit(lambda p, m: htdemucs_segment(p, m, jcfg))(
        JP.unflatten_tree(flat), jnp.asarray(mix)))
    assert ours.shape == ref.shape == (batch, tcfg.num_sources, 2, length)
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max()
    scale = np.abs(ref).max()
    assert diff < TOL * max(scale, 1.0), (diff, scale)
    return ours


@pytest.mark.parametrize("jcfg,tcfg", [(J4S, HTDEMUCS_4S), (J6S, HTDEMUCS_6S)],
                         ids=["4s", "6s"])
def test_htdemucs_matches_jax(jcfg, tcfg):
    _compare(jcfg, tcfg, SEG)


def test_htdemucs_batch_and_ragged_length():
    """Two items and a length that is not a multiple of the STFT hop (the
    time encoders' stride padding and the spec's right pad)."""
    _compare(J4S, HTDEMUCS_4S, SEG - 1000, batch=2, seed=1)


@pytest.mark.slow
def test_htdemucs_matches_jax_full_segment():
    """The full 7.8 s segment: the only length that reaches the 336-frame
    spectrogram and its odd bookkeeping."""
    _compare(J4S, HTDEMUCS_4S, 343980)

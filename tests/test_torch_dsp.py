"""demucs_tpu_torch.dsp against demucs_tpu.dsp on the CPU (its FFT path).

Both sides compute in float32 with an FFT; they differ only in the
order of floating-point sums, so each comparison allows 1e-5 of the
reference's largest magnitude (about 80 float32 ulps at that scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu import dsp as J

from demucs_tpu_torch import dsp as T

RTOL = 1e-5


def _close(ours, ref, rtol=RTOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _audio(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def test_window_and_sumsquare_identical():
    np.testing.assert_array_equal(T.hann_window(4096), J.hann_window(4096))
    np.testing.assert_array_equal(T._window_sumsquare(12), J._window_sumsquare(12))
    np.testing.assert_allclose(T.hann_window(4096),
                               torch.hann_window(4096, periodic=True).numpy(),
                               atol=1e-6)


def test_stft_matches():
    x = _audio((2, 3, 8192))
    _close(T.stft(torch.from_numpy(x)), J.stft(jnp.asarray(x)))


def test_istft_matches_and_inverts():
    x = _audio((2, 8192), seed=1)
    z = np.array(J.stft(jnp.asarray(x)))
    ours = T.istft(torch.from_numpy(z), 8192)
    _close(ours, J.istft(jnp.asarray(z), 8192))
    np.testing.assert_allclose(ours.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("length", [10000, 32768])
def test_spec_ispec_match(length):
    x = _audio((1, 2, length), seed=2)
    z = T.spec(torch.from_numpy(x))
    _close(z, J.spec(jnp.asarray(x)))
    y = T.ispec(z, length)
    _close(y, J.ispec(jnp.asarray(z.numpy()), length))


def test_cac_pack_unpack():
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((2, 2, 16, 5))
         + 1j * rng.standard_normal((2, 2, 16, 5))).astype(np.complex64)
    zt = torch.from_numpy(z)
    np.testing.assert_array_equal(T.cac_pack(zt).numpy(), np.asarray(J.cac_pack(jnp.asarray(z))))
    np.testing.assert_array_equal(T.cac_unpack(T.cac_pack(zt)).numpy(), z)
    np.testing.assert_array_equal(T.cac_pack_fmajor(zt).numpy(),
                                  np.asarray(J.cac_pack_fmajor(jnp.asarray(z))))


def test_spec_cac_fmajor_matches():
    x = _audio((2, 2, 12288), seed=4)
    ours = T.spec_cac_fmajor(torch.from_numpy(x))
    assert ours.shape == (2, 2048, 4, 12)
    _close(ours, J.spec_cac_fmajor(jnp.asarray(x)))


@pytest.mark.parametrize("bin_offset", [0, 2])
def test_ispec_cac_fmajor_matches(bin_offset):
    rng = np.random.default_rng(5)
    sources, length = 3, 10000
    bins = 2048 + 2 * bin_offset
    x = rng.standard_normal((2, bins, sources * 4, 10)).astype(np.float32)
    ours = T.ispec_cac_fmajor(torch.from_numpy(x), sources, length,
                              bin_offset=bin_offset)
    ref = J.ispec_cac_fmajor(jnp.asarray(x), sources, length,
                             bin_offset=bin_offset)
    assert ours.shape == (2, sources, 2, length)
    _close(ours, ref)

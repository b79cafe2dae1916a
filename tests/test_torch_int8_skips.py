"""INT8_SKIPS (`DT_INT8_SKIPS`, the int8 storage of htdemucs' encoder
skips) in demucs_tpu_torch against demucs_tpu on the CPU: the quantizer
and dequantizer bit for bit on the same numpy tensors, and a narrow
htdemucs-4s with the switch on in both packages, the port within a tenth
of what the switch moves the JAX output, and the switch's own effect on
the port positive and under the JAX test's gate (tests/test_quant.py:
the fp8 relative bound, dSDR <= 0.05 dB at a nominal 10 dB)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.models import htdemucs as JM
from demucs_tpu.models import htdemucs_segment

from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_htdemucs
from demucs_tpu_torch.models import htdemucs as TM
from demucs_tpu_torch.params import from_jax_params

from _torch_threads import _one_torch_thread  # noqa: F401
from test_quant import _FP8_REL_GATE

SMALL = dict(channels=16, bottom_channels=64, t_layers=2)
SEG = 16384


@pytest.fixture
def skips_on(monkeypatch):
    monkeypatch.setattr(JM, "INT8_SKIPS", True)
    monkeypatch.setattr(TM, "INT8_SKIPS", True)


def test_switch_is_off_by_default():
    assert TM.INT8_SKIPS is JM.INT8_SKIPS is False


@pytest.mark.parametrize("shape,ch_axis", [((2, 32, 48, 21), 2), ((2, 48, 97), 1),
                                           ((1, 8, 5), -2)])
def test_quantizer_matches_jax_bit_for_bit(skips_on, shape, ch_axis):
    x = (np.random.default_rng(0).standard_normal(shape) * 3.0).astype(np.float32)
    x[(slice(None),) * (ch_axis % len(shape)) + (1,)] = 0.0  # a channel at the scale floor
    jq, jscale = JM._quantize_skip(jnp.asarray(x), ch_axis)
    tq, tscale = TM._quantize_skip(torch.from_numpy(x), ch_axis)
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tscale.numpy().tobytes() == np.asarray(jscale).tobytes()
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(JM._dequant_skip((jq, jscale), jdt).astype(jnp.float32))
        td = TM._dequant_skip((tq, tscale), tdt)
        assert td.dtype == tdt
        assert td.float().numpy().tobytes() == jd.tobytes()


def test_narrow_model_with_int8_skips_matches_jax(monkeypatch):
    jcfg = dataclasses.replace(J4S, **SMALL)
    tcfg = dataclasses.replace(HTDEMUCS_4S, **SMALL)
    flat = {k: np.asarray(v, np.float32)
            for k, v in JP.init_flat(JP.htdemucs_schema(jcfg), seed=3).items()}
    model = build_htdemucs(tcfg, from_jax_params(flat), "cpu")
    params = JP.unflatten_tree(flat)
    mix = (np.random.default_rng(0).standard_normal((1, 2, SEG)) * 0.1).astype(np.float32)
    out = {}
    for on in (False, True):
        monkeypatch.setattr(JM, "INT8_SKIPS", on)
        monkeypatch.setattr(TM, "INT8_SKIPS", on)
        jax_out = np.asarray(jax.jit(lambda p, m: htdemucs_segment(p, m, jcfg))(
            params, jnp.asarray(mix)))
        with torch.inference_mode():
            out[on] = jax_out, model(torch.from_numpy(mix)).numpy()
    (jax_off, port_off), (jax_on, port_on) = out[False], out[True]
    moved = np.linalg.norm(jax_on - jax_off)
    assert moved > 0
    assert np.linalg.norm(port_on - jax_on) <= 0.1 * moved
    err = np.linalg.norm(port_on - port_off) / np.linalg.norm(port_off)
    assert 0 < err < _FP8_REL_GATE, err

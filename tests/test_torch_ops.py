"""demucs_tpu_torch.ops against demucs_tpu.ops on the CPU.

Same numpy inputs from a seed go through both. Everything runs in
float32; the two differ only in the order of floating-point sums
(convolution and matmul algorithms), so comparisons allow 1e-5 of the
reference's largest magnitude unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu import ops as JO
from demucs_tpu.ops import attention as JA
from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu.params import unflatten_tree

from demucs_tpu_torch import ops as TO
from demucs_tpu_torch.models.htdemucs import CrossTransformerLayer
from demucs_tpu_torch.ops.cuda import flash_mha, flash_mha_plain

RTOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rtol=RTOL):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


# --- norms and activations -------------------------------------------------

def test_gelu():
    x = _rand(3, 7, 11, scale=3.0)
    _close(TO.gelu(_t(x)), JO.gelu(jnp.asarray(x)))


@pytest.mark.parametrize("axis,with_bias", [(1, False), (2, True), (-1, False)])
def test_glu(axis, with_bias):
    x = _rand(2, 6, 8, 4, seed=1)
    bias = _rand(x.shape[axis], seed=2) if with_bias else None
    ours = TO.glu(_t(x), axis, None if bias is None else _t(bias))
    ref = JO.glu(jnp.asarray(x), axis, None if bias is None else jnp.asarray(bias))
    _close(ours, ref)


def test_layer_norm():
    x = _rand(2, 9, 32, seed=3, scale=2.0) + 0.5
    w, b = _rand(32, seed=4) + 1.0, _rand(32, seed=5)
    _close(TO.layer_norm(_t(x), _t(w), _t(b)),
           JO.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm(groups):
    x = _rand(2, 8, 5, 6, seed=6) + 0.3
    w, b = _rand(8, seed=7) + 1.0, _rand(8, seed=8)
    _close(TO.group_norm(_t(x), _t(w), _t(b), groups),
           JO.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups))


def test_group_norm_fmajor():
    x = _rand(2, 5, 8, 6, seed=9) - 0.2
    w, b = _rand(8, seed=10) + 1.0, _rand(8, seed=11)
    _close(TO.group_norm_fmajor(_t(x), _t(w), _t(b), 4),
           JO.group_norm_fmajor(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4))


def test_layer_scale():
    x, s = _rand(2, 6, 5, seed=12), _rand(6, seed=13)
    _close(TO.layer_scale(_t(x), _t(s)), JO.layer_scale(jnp.asarray(x), jnp.asarray(s)))


# --- convolutions ----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(stride=4, padding=2),                  # time encoder
    dict(stride=1, padding=2, dilation=2),      # DConv compress
    dict(stride=1, padding=1),                  # time decoder rewrite
    dict(stride=1, padding=0),                  # 1x1
])
def test_conv1d(kw):
    k = 1 if kw["padding"] == 0 else (8 if kw["stride"] == 4 else 3)
    x, w, b = _rand(2, 6, 40, seed=14), _rand(5, 6, k, seed=15), _rand(5, seed=16)
    _close(TO.conv1d(_t(x), _t(w), _t(b), **kw),
           JO.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))


@pytest.mark.parametrize("kw", [
    dict(stride=(4, 1), padding=(2, 0)),
    dict(stride=(1, 1), padding=(1, 1)),
])
def test_conv2d(kw):
    kh, kwd = (8, 1) if kw["stride"][0] == 4 else (3, 3)
    x = _rand(2, 4, 24, 5, seed=17)
    w, b = _rand(6, 4, kh, kwd, seed=18), _rand(6, seed=19)
    _close(TO.conv2d(_t(x), _t(w), _t(b), **kw),
           JO.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))


def test_freq_conv_fmajor():
    x, w, b = _rand(2, 32, 4, 5, seed=20), _rand(6, 4, 8, 1, seed=21), _rand(6, seed=22)
    _close(TO.freq_conv_fmajor(_t(x), _t(w), _t(b), stride=4, padding=2),
           JO.freq_conv_fmajor(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=4, padding=2))


@pytest.mark.parametrize("wshape", [(6, 4, 1, 1), (6, 4)])
def test_freq_conv1x1_fmajor(wshape):
    x, w, b = _rand(2, 7, 4, 5, seed=23), _rand(*wshape, seed=24), _rand(6, seed=25)
    _close(TO.freq_conv1x1_fmajor(_t(x), _t(w), _t(b)),
           JO.freq_conv1x1_fmajor(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def test_freq_conv3x3_fmajor():
    x, w, b = _rand(2, 7, 4, 5, seed=26), _rand(6, 4, 3, 3, seed=27), _rand(6, seed=28)
    _close(TO.freq_conv3x3_fmajor(_t(x), _t(w), _t(b)),
           JO.freq_conv3x3_fmajor(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    _close(TO.freq_conv3x3_fmajor(_t(x), _t(w)),
           JO.freq_conv3x3_fmajor(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("padding", [0, 2])
def test_freq_convtr_fmajor(padding):
    x, w, b = _rand(2, 9, 6, 5, seed=29), _rand(6, 4, 8, 1, seed=30), _rand(4, seed=31)
    ours = TO.freq_convtr_fmajor(_t(x), _t(w), _t(b), stride=4, padding=padding)
    assert ours.shape == (2, 36 + 4 - 2 * padding, 4, 5)
    _close(ours, JO.freq_convtr_fmajor(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), stride=4, padding=padding))


@pytest.mark.parametrize("stride,padding", [(4, 0), (4, 2), (3, 1)])
def test_conv_transpose1d(stride, padding):
    x, w, b = _rand(2, 6, 11, seed=32), _rand(6, 4, 8, seed=33), _rand(4, seed=34)
    _close(TO.conv_transpose1d(_t(x), _t(w), _t(b), stride, padding),
           JO.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride, padding))


@pytest.mark.parametrize("kh,kw,stride,padding", [
    (8, 1, (4, 1), (2, 0)), (3, 3, (2, 2), (1, 1))])
def test_conv_transpose2d(kh, kw, stride, padding):
    x = _rand(2, 6, 9, 5, seed=35)
    w, b = _rand(6, 4, kh, kw, seed=36), _rand(4, seed=37)
    _close(TO.conv_transpose2d(_t(x), _t(w), _t(b), stride, padding),
           JO.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride, padding))


# --- embeddings --------------------------------------------------------------

def test_embeddings_identical():
    np.testing.assert_array_equal(TO.create_sin_embedding(37, 64),
                                  JO.create_sin_embedding(37, 64))
    np.testing.assert_array_equal(TO.create_2d_sin_embedding(64, 8, 13),
                                  JO.create_2d_sin_embedding(64, 8, 13))


# --- attention ---------------------------------------------------------------

def test_linear():
    x, w, b = _rand(2, 5, 16, seed=38), _rand(8, 16, seed=39), _rand(8, seed=40)
    _close(TO.linear(_t(x), _t(w), _t(b)),
           JA.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("T,S", [(24, 24), (40, 16)])
def test_multihead_attention(T, S):
    B, C, H = 2, 64, 4
    q, kv = _rand(B, T, C, seed=41, scale=0.5), _rand(B, S, C, seed=42, scale=0.5)
    ipw, ipb = _rand(3 * C, C, seed=43, scale=0.1), _rand(3 * C, seed=44, scale=0.05)
    opw, opb = _rand(C, C, seed=45, scale=0.1), _rand(C, seed=46, scale=0.05)
    args = (q, kv, ipw, ipb, opw, opb)
    _close(TO.multihead_attention(*map(_t, args), H),
           JA.multihead_attention(*map(jnp.asarray, args), H))


def _layer_params(d, hidden, cross, seed):
    """Random numpy weights for one transformer layer, by state-dict name."""
    with torch.device("meta"):
        layer = CrossTransformerLayer(d, 4, hidden, cross)
    rng = np.random.default_rng(seed)
    flat = {}
    for name, p in layer.state_dict().items():
        arr = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if name.endswith(("norm1.weight", "norm2.weight", "norm3.weight",
                          "norm_out.weight", "scale")):
            arr = 1.0 + 0.1 * arr
        else:
            arr = arr * (0.2 / np.sqrt(p.shape[-1]))
        flat[name] = arr
    layer = CrossTransformerLayer(d, 4, hidden, cross)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return layer, unflatten_tree(flat)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_transformer_layer(cross):
    d, hidden = 64, 128
    layer, p = _layer_params(d, hidden, cross, seed=47)
    x = _rand(2, 30, d, seed=48)
    kv = _rand(2, 18, d, seed=49) if cross else None
    ours = layer(_t(x), None if kv is None else _t(kv))
    ref = JA.transformer_layer(jnp.asarray(x), None if kv is None else jnp.asarray(kv),
                               p, num_heads=4)
    _close(ours, ref)


@pytest.mark.parametrize("D", [64, 48])
def test_flash_plain_matches_pallas_kernel(D):
    """The plain version against the Pallas kernel itself (interpret
    mode), at lengths that are not multiples of the CUDA kernel's
    64-row and 32-key tiles."""
    q = _rand(1, 2, 40, D, seed=50)
    k, v = _rand(1, 2, 24, D, seed=51), _rand(1, 2, 24, D, seed=52)
    ours = flash_mha_plain(_t(q), _t(k), _t(v))
    ref = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    _close(ours, ref)


def test_flash_wrapper_on_cpu_tensors():
    """For CPU tensors the wrapper is the plain version (any head dim),
    launches nothing, and keeps the operands' dtype."""
    q, k, v = (_t(_rand(2, 3, n, 16, seed=53 + i)) for i, n in enumerate((9, 5, 5)))
    before = flash_mha.launches
    out = flash_mha(q, k, v)
    assert flash_mha.launches == before
    torch.testing.assert_close(out, flash_mha_plain(q, k, v), rtol=0, atol=0)
    ref = torch.softmax(q @ k.transpose(-1, -2) / 4.0, -1) @ v
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    out16 = flash_mha(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_mha(q.to("meta"), k.to("meta"), v.to("meta"))

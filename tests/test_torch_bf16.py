"""demucs_tpu_torch's bf16 inference (`--bf16`, alone and with --int8 /
--fp8) against demucs_tpu on the CPU.

What the JAX package computes, and so the port:
  * `--bf16` alone casts every weight to bf16 (`cli.py`'s tree map), and
    the network runs in bf16: the spectrum rounded to bf16 before its f32
    statistics, the epilogue's spectrum rounded before the f32 inverse
    STFT. The port's kernels K4, K5, K6 follow the TPU kernels' bf16
    semantics (read bf16, compute in f32, round once; K6 keeps c and the
    gates in f32 and h in bf16), so each twin is held against its Pallas
    kernel in interpret mode at the bf16 tolerance the port uses for
    K1/K2 (1e-2 of max(scale, 1)), and the models against the JAX graph
    within bf16's own noise: ||port_bf16 - jax_bf16|| <= 2 ||jax_bf16 -
    jax_f32||, and within the JAX package's bound of 0.08 relative to f32
    (tests/test_model_v4.py). v3's JAX side runs its Pallas BiLSTM (in
    interpret mode), whose c is f32, as the port's K6.
  * `--bf16 --int8` / `--bf16 --fp8` quantize the f32 weights and widen
    each quantized weight as bf16(bf16(q) * bf16(scale))
    (`quantized_model_fn(fn, jnp.bfloat16)`); the dense weights, the first
    encoder's conv among them, stay f32, so the network is f32 and these
    are held to the f32 tolerance, 1e-5 of max(scale, 1).

Weights come from `init_flat`, inputs from numpy seeds. One JAX graph per
family and weight tree; each is cached for the file's tests.

    python -m pytest -q tests/test_torch_bf16.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import audio as JAud
from demucs_tpu import params as JP
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HDEMUCS_V3 as JV3, HTDEMUCS_4S as J4S
from demucs_tpu.models import hdemucs_v3_segment, htdemucs_segment
from demucs_tpu.ops import lstm as JLSTM
from demucs_tpu.ops.pallas import attention as JPA
from demucs_tpu.ops.pallas.dconv import dconv_sub_block as pallas_dconv_sub_block
from demucs_tpu.ops.pallas.lstm import bilstm_recurrence as pallas_bilstm_recurrence
from demucs_tpu.ops.pallas.norms import gn_glu_scale_res as pallas_gn_glu_scale_res
from demucs_tpu.params import quant as JQ

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import ops as TO
from demucs_tpu_torch.cli import main as torch_main
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S
from demucs_tpu_torch.models import build_model
from demucs_tpu_torch.ops.cuda import (bilstm_recurrence, bilstm_recurrence_plain,
                                       dconv_sub_block, dconv_sub_block_plain,
                                       gn_glu_scale_res, gn_glu_scale_res_plain, int8_matmul,
                                       int8_matmul_plain)
from demucs_tpu_torch.params import cast_state_dict, from_jax_params
from demucs_tpu_torch.params import quant as TQ
from demucs_tpu_torch.pipeline import ApplyOptions, Separator

from _torch_threads import _one_torch_thread  # noqa: F401

BF16 = jnp.bfloat16
TOL_BF16 = 1e-2   # of max(scale, 1): the port's bf16 kernel tolerance
TOL_F32 = 1e-5    # of max(scale, 1): an f32 network
JAX_BF16_BOUND = 0.08  # ||bf16 - f32|| / ||f32||, tests/test_model_v4.py
LENGTH = 8192
# a v4 small enough for the CPU in which every kind of quantized leaf
# still reaches the quantizer's 4096 elements (tests/test_torch_quant.py)
SMALL = dict(channels=16, bottom_channels=64, t_layers=2)
FAMILIES = {
    "htdemucs": (dataclasses.replace(J4S, **SMALL), dataclasses.replace(HTDEMUCS_4S, **SMALL),
                 JP.htdemucs_schema, htdemucs_segment),
    "hdemucs_mmi": (JV3, HDEMUCS_V3, JP.hdemucs_v3_schema, hdemucs_v3_segment),
}


def _rand(*shape, seed=0, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + offset).astype(np.float32)


def _bits(t) -> np.ndarray:
    """A tensor's or array's raw 16- or 32-bit patterns."""
    a = t.view(torch.int16).numpy() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 \
        else np.ascontiguousarray(np.asarray(t))
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _bf16(a) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even) and widened back."""
    return np.asarray(jnp.asarray(a, BF16), np.float32)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1.0), (err, scale)


@functools.lru_cache(maxsize=None)
def _flat(family: str) -> dict:
    """The family's weights in f32 (init_flat leaves some in f64)."""
    jcfg, _, schema, _ = FAMILIES[family]
    return {k: np.asarray(v, np.float32) for k, v in JP.init_flat(schema(jcfg), seed=0).items()}


@functools.lru_cache(maxsize=None)
def _mix() -> np.ndarray:
    return _rand(1, 2, LENGTH, seed=42, scale=0.1)


@functools.lru_cache(maxsize=None)
def _jax_out(family: str, mode: str) -> np.ndarray:
    """The JAX graph's output: f32 weights ("f32"), the CLI's --bf16 tree
    ("bf16"), or --bf16 with --int8 / --fp8 ("bf16_int8", "bf16_fp8").
    hdemucs_mmi's BiLSTM runs the Pallas kernel (interpret mode)."""
    jcfg, _, _, segment = FAMILIES[family]
    tree = JP.unflatten_tree(_flat(family))
    fn = lambda p, m: segment(p, m, jcfg)  # noqa: E731
    if mode == "bf16":
        tree = jax.tree.map(lambda x: jnp.asarray(x, BF16), tree)
    fn = jax.jit(fn)
    if mode.startswith("bf16_"):
        # the widening outside the jit: inside it, XLA:CPU computes
        # bf16(q) * bf16(scale) in f32 and drops the product's rounding to
        # bf16 where it fuses the product into its consumer (the weight
        # then differs from `dequantize_tree`'s by up to 2^-9 relative)
        tree = {"bf16_int8": JQ.quantize_int8, "bf16_fp8": JQ.quantize_fp8}[mode](tree)
        fn = JQ.quantized_model_fn(fn, BF16)
    old = JLSTM.USE_PALLAS, JPA.INTERPRET
    try:
        JLSTM.USE_PALLAS, JPA.INTERPRET = True, True
        return np.asarray(fn(tree, jnp.asarray(_mix())), np.float32)
    finally:
        JLSTM.USE_PALLAS, JPA.INTERPRET = old


def _port_out(family: str, mode: str) -> np.ndarray:
    _, tcfg, _, _ = FAMILIES[family]
    sd = from_jax_params(_flat(family))
    quant_dtype = torch.float32
    if mode == "bf16":
        sd = cast_state_dict(sd, torch.bfloat16)
    elif mode.startswith("bf16_"):
        sd = {"bf16_int8": TQ.quantize_int8, "bf16_fp8": TQ.quantize_fp8}[mode](sd)
        quant_dtype = torch.bfloat16
    model = build_model(tcfg, sd, "cpu", quant_dtype=quant_dtype)
    with torch.inference_mode():
        out = model(torch.from_numpy(_mix()))
    assert out.dtype == torch.float32
    return out.numpy()


# --- weights ------------------------------------------------------------------

def test_bf16_weights_carry_over_bitwise():
    """A bf16 JAX tree crosses `from_jax_params` bit for bit, and
    `cast_state_dict` rounds f32 weights to the same bits as the JAX CLI's
    tree map; a quantized dict keeps its q and scale pairs, but its
    LayerScales (also named `.scale`) are cast."""
    flat = _flat("htdemucs")
    ref = JP.flatten_tree(jax.tree.map(lambda x: jnp.asarray(x, BF16), JP.unflatten_tree(flat)))
    carried = from_jax_params(ref)
    cast = cast_state_dict(from_jax_params(flat), torch.bfloat16)
    assert set(carried) == set(cast) == set(flat)
    for name, arr in ref.items():
        assert carried[name].dtype == cast[name].dtype == torch.bfloat16, name
        assert np.array_equal(_bits(carried[name]), _bits(np.asarray(arr))), name
        assert np.array_equal(_bits(cast[name]), _bits(np.asarray(arr))), name
    q = TQ.quantize_int8(from_jax_params(flat))
    qcast = cast_state_dict(q, torch.bfloat16)
    for name, t in q.items():
        held = name.endswith(".q") or (name.endswith(".scale") and f"{name[:-6]}.q" in q)
        assert qcast[name] is t if held else qcast[name].dtype == torch.bfloat16, name
    assert qcast["encoder.0.dconv.layers.0.6.scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_dense_bf16_matches_dequantize_tree(kind):
    """`QuantizedWeight.dense()` widened to bf16 equals `dequantize_tree(q,
    jnp.bfloat16)` bit for bit on every quantized weight of a narrow
    htdemucs; the dense entries it leaves alone."""
    flat = _flat("htdemucs")
    jq = {"int8": JQ.quantize_int8, "fp8": JQ.quantize_fp8}[kind]
    tq = {"int8": TQ.quantize_int8, "fp8": TQ.quantize_fp8}[kind]
    ref = JP.flatten_tree(JQ.dequantize_tree(jq(JP.unflatten_tree(flat)), BF16))
    sd = tq(from_jax_params(flat))
    names = [n[:-2] for n in sd if n.endswith(".q")]
    assert len(names) > 10
    for name in names:
        w = TO.QuantizedWeight(sd[f"{name}.q"], sd[f"{name}.scale"], torch.bfloat16)
        ours = TO.dense(w)
        assert ours.dtype == torch.bfloat16 and np.asarray(ref[name]).dtype.name == "bfloat16"
        assert np.array_equal(_bits(ours), _bits(np.asarray(ref[name]))), name
        assert TO.dense(TO.QuantizedWeight(w.q, w.scale)).dtype == torch.float32
    for name in set(flat) - set(names):
        assert np.asarray(ref[name]).dtype == np.float32, name


def test_int8_matmul_bf16_weight_mode_matches_dequantize_tree():
    """K7's bf16-rounded-weight mode (its twin on CPU tensors): x @ w^T + b
    for the weight `dequantize_tree` widens to bf16, bit for bit, with no
    scale after the sum; through `ops.linear` too. The f32 mode stays the
    scale-after-sum function."""
    M, K, N = 37, 96, 80
    x, b = _rand(M, K, seed=1), _rand(N, seed=2, scale=0.1)
    w = _rand(N, K, seed=3, scale=0.1)
    qt = JQ.quantize_int8({"w": {"weight": w}})["w"]["weight"]
    wide = torch.from_numpy(np.asarray(JQ.dequantize_tree(qt, BF16), np.float32))
    q, s = torch.from_numpy(np.asarray(qt["q"])), torch.from_numpy(np.asarray(qt["scale"]))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    want = xt @ wide.T + bt
    before = int8_matmul.launches
    ours = int8_matmul(xt, q, s.reshape(-1), bt, weight_dtype=torch.bfloat16)
    assert int8_matmul.launches == before  # CPU tensors: the plain twin
    assert torch.equal(ours, want)
    layer = TO.linear(xt.reshape(1, M, K), TO.QuantizedWeight(q, s, torch.bfloat16), bt)
    assert torch.equal(layer.reshape(M, N), want)
    assert torch.equal(int8_matmul_plain(xt, q, s.reshape(-1), bt),
                       (xt @ q.float().T) * s.reshape(-1) + bt)
    with pytest.raises(ValueError, match="widens"):
        int8_matmul(xt, q, s.reshape(-1), bt, weight_dtype=torch.float16)


# --- the kernels' bf16 twins against the Pallas kernels ------------------------

def test_dconv_sub_block_bf16_twin_matches_pallas():
    """K5's twin on bf16 inputs: the f32 chain on the widened inputs,
    rounded once, as the Pallas `_sub_block_kernel` computes it."""
    N, C, h, T = 3, 16, 4, 37
    ws = [_bf16(_rand(h, C, 3, seed=1, scale=0.3)), _bf16(_rand(h, seed=2, scale=0.2)),
          _bf16(_rand(h, seed=3, scale=0.2, offset=1.0)), _bf16(_rand(h, seed=4, scale=0.2)),
          _bf16(_rand(2 * C, h, 1, seed=5, scale=0.3)), _bf16(_rand(2 * C, seed=6, scale=0.2)),
          _bf16(_rand(2 * C, seed=7, scale=0.2, offset=1.0)),
          _bf16(_rand(2 * C, seed=8, scale=0.2)), _bf16(_rand(C, seed=9, scale=0.1))]
    x = _bf16(_rand(N, C, T, seed=10, scale=0.5, offset=0.1))
    for dil in (1, 2):
        ours = dconv_sub_block_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                       for a in (x, *ws)), dil)
        assert ours.dtype == torch.bfloat16
        ref = pallas_dconv_sub_block(*(jnp.asarray(a, BF16) for a in (x, *ws)), dil=dil,
                                     interpret=True)
        assert ref.dtype == BF16
        _close(ours.float(), np.asarray(ref, np.float32), TOL_BF16)
        # f32 in, rounded once: the twin of the widened inputs, in bf16
        f32 = dconv_sub_block_plain(*(torch.from_numpy(a) for a in (x, *ws)), dil)
        assert torch.equal(ours, f32.to(torch.bfloat16))
        assert torch.equal(dconv_sub_block(*(torch.from_numpy(a).to(torch.bfloat16)
                                             for a in (x, *ws)), dil), ours)


def test_gn_glu_scale_res_bf16_twin_matches_pallas():
    """K4's twin on bf16 inputs against the Pallas `_gn_glu_res_kernel`."""
    R, C, T = 2, 24, 41
    args = [_bf16(_rand(R, 2 * C, T, seed=1, offset=0.3)),
            _bf16(_rand(2 * C, seed=2, scale=0.2, offset=1.0)), _bf16(_rand(2 * C, seed=3,
                                                                            scale=0.2)),
            _bf16(_rand(C, seed=4, scale=0.1)), _bf16(_rand(R, C, T, seed=5))]
    ours = gn_glu_scale_res(*(torch.from_numpy(a).to(torch.bfloat16) for a in args))
    assert ours.dtype == torch.bfloat16
    ref = pallas_gn_glu_scale_res(*(jnp.asarray(a, BF16) for a in args), interpret=True)
    _close(ours.float(), np.asarray(ref, np.float32), TOL_BF16)
    f32 = gn_glu_scale_res_plain(*(torch.from_numpy(a) for a in args))
    assert torch.equal(ours, f32.to(torch.bfloat16))


def test_bilstm_recurrence_bf16_twin_matches_pallas():
    """K6's twin on bf16 xs and w_hh against the Pallas `_bilstm_kernel`:
    gates and c in f32, h rounded to bf16 each step; in f32 the twin is
    the lax.scan recurrence as before (tests/test_torch_v3.py)."""
    T, B, H = 29, 3, 16
    xs = _bf16(_rand(T, 2, B, 4 * H, seed=1))
    w_hh = _bf16(_rand(2, H, 4 * H, seed=2, scale=0.2))
    ours = bilstm_recurrence(torch.from_numpy(xs).to(torch.bfloat16),
                             torch.from_numpy(w_hh).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and ours.shape == (T, 2, B, H)
    ref = pallas_bilstm_recurrence(jnp.asarray(xs, BF16), jnp.asarray(w_hh, BF16),
                                   interpret=True)
    assert ref.dtype == BF16
    _close(ours.float(), np.asarray(ref, np.float32), TOL_BF16)
    # the XLA scan carries c in bf16: a different function, further off
    scan = np.asarray(JLSTM._scan_recurrence(jnp.asarray(xs, BF16), jnp.asarray(w_hh, BF16)),
                      np.float32)
    assert np.abs(ours.float().numpy() - np.asarray(ref, np.float32)).max() \
        <= np.abs(scan - np.asarray(ref, np.float32)).max()


# --- the models ---------------------------------------------------------------

def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("family", ["htdemucs", "hdemucs_mmi"])
def test_bf16_model_matches_jax(family):
    """--bf16: the port's bf16 network within 0.08 of the JAX f32 graph,
    and no further from the JAX bf16 graph than twice that graph's own
    bf16 error."""
    ours = _port_out(family, "bf16")
    ref32, ref16 = _jax_out(family, "f32"), _jax_out(family, "bf16")
    assert ours.shape == ref16.shape and np.isfinite(ours).all()
    noise = np.linalg.norm(ref16 - ref32)
    assert _rel(ours, ref32) < JAX_BF16_BOUND, _rel(ours, ref32)
    assert np.linalg.norm(ours - ref16) <= 2 * noise, (np.linalg.norm(ours - ref16), noise)


@pytest.mark.parametrize("family,kind", [("htdemucs", "int8"), ("htdemucs", "fp8"),
                                         ("hdemucs_mmi", "int8"), ("hdemucs_mmi", "fp8")])
def test_bf16_quantized_model_matches_jax(family, kind):
    """--bf16 --int8 / --fp8: quantized weights widened to bf16 in an f32
    network, against `quantized_model_fn(fn, jnp.bfloat16)` at the f32
    tolerance; the first encoder's conv stays a dense f32 weight."""
    ours = _port_out(family, f"bf16_{kind}")
    _close(ours, _jax_out(family, f"bf16_{kind}"), TOL_F32)
    flat = _flat(family)
    assert not JQ.should_quantize("encoder/0/conv/weight", flat["encoder.0.conv.weight"])


def test_bf16_model_through_the_track_paths():
    """A bf16 model through the port's track paths (they take and return
    f32 whatever the network's dtype): the default batched path, the
    fused pass and `separate_many` of two tracks agree within the bf16
    tolerance (segments batch together differently on each path), and
    each stays within the JAX package's 0.08 of the f32 model."""
    _, tcfg, _, _ = FAMILIES["htdemucs"]
    sd = from_jax_params(_flat("htdemucs"))
    models = {dt: build_model(tcfg, cast_state_dict(sd, dt) if dt == torch.bfloat16 else sd,
                              "cpu") for dt in (torch.float32, torch.bfloat16)}
    tracks = [_rand(2, 12000, seed=6, scale=0.2), _rand(2, 7000, seed=7, scale=0.3)]
    opts = ApplyOptions(batch_size=2, shift_offset=100).with_segment(LENGTH)
    seps = {name: Separator(models[dt], tcfg.num_sources, o, "cpu")
            for name, dt, o in (("f32", torch.float32, opts), ("bf16", torch.bfloat16, opts),
                                ("fused", torch.bfloat16,
                                 dataclasses.replace(opts, fused_track=True)))}
    ref32 = [seps["f32"](t) for t in tracks]
    default = [seps["bf16"](t) for t in tracks]
    for outs in (default, [seps["fused"](t) for t in tracks], seps["bf16"].separate_many(tracks)):
        for out, ref, r32 in zip(outs, default, ref32):
            assert out.dtype == np.float32 and out.shape == r32.shape
            _close(out, ref, TOL_BF16)
            assert _rel(out, r32) < JAX_BF16_BOUND, _rel(out, r32)


def test_bf16_int8_cli_matches_jax_cli(tmp_path):
    """Both CLIs with --bf16 --int8 on the same WAV and full-width
    htdemucs-4s weights (16384-sample segments, pinned shift) write
    matching stems (an f32 network: the f32 tolerance); the port's CLI
    with --bf16 alone writes finite stems of the track's length."""
    model = tmp_path / "4s.bin"
    JP.write_ggml(model, "htdemucs_4s", JP.init_flat(JP.htdemucs_schema(J4S), seed=0))
    wav = tmp_path / "in.wav"
    JAud.write_wav(wav, _rand(2, 20000, seed=3, scale=0.2))
    common = ["--offset", "1337", "--batch", "2", "--segment-samples", "16384", "--bf16"]
    assert torch_main([str(model), str(wav), str(tmp_path / "port"), "--device", "cpu",
                       "--int8"] + common) == 0
    assert jax_main([str(model), str(wav), str(tmp_path / "jax"), "--no-mesh",
                     "--int8"] + common) == 0
    assert torch_main([str(model), str(wav), str(tmp_path / "bf16"), "--device", "cpu"]
                      + common) == 0
    for i, name in enumerate(J4S.sources):
        stem = f"target_{i}_{name}.wav"
        ours, rate = TAud.read_wav(tmp_path / "port" / stem)
        ref, _ = TAud.read_wav(tmp_path / "jax" / stem)
        assert rate == 44100 and ours.shape == ref.shape == (2, 20000)
        _close(ours, ref, TOL_F32)
        bf16, _ = TAud.read_wav(tmp_path / "bf16" / stem)
        assert bf16.shape == (2, 20000) and np.isfinite(bf16).all()

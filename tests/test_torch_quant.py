"""demucs_tpu_torch's weight-only quantization (--int8, --fp8) against
demucs_tpu's on the CPU: the quantized state dicts, K7's plain twin
against the Pallas int8_matmul, the int8 and fp8 models against
`quantized_model_fn` of the JAX segment graphs, the modules' int8
buffers, and both CLIs with --int8.

Inputs come from numpy seeds and weights from `demucs_tpu.params.init_flat`.
Both packages quantize the same f32 weights to the same bits; the
graphs then differ only in the order of sums (and the port's int8
linears scale after the sum, the JAX graph before it), so the models are
held to 1e-5 of their output's scale, as tests/test_torch_model.py holds
the dense ones.
"""

import dataclasses

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
from demucs_tpu.ops.pallas.quant_matmul import int8_linear, int8_matmul as pallas_int8_matmul
from demucs_tpu.params import quant as JQ

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import ops as TO
from demucs_tpu_torch.cli import main as torch_main
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S
from demucs_tpu_torch.models import build_htdemucs, build_model
from demucs_tpu_torch.ops.cuda import int8_matmul, int8_matmul_plain
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.params import quant as TQ

from _torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5
# a v4 small enough for the CPU in which every kind of quantized leaf
# (linear, conv, transposed conv, DConv conv) still reaches _MIN_SIZE
SMALL = dict(channels=16, bottom_channels=64, t_layers=2)
QUANT = {"int8": (JQ.quantize_int8, TQ.quantize_int8),
         "fp8": (JQ.quantize_fp8, TQ.quantize_fp8)}


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else np.uint32)


def _quantized(kind, flat):
    """The JAX package's quantized tree, flattened to dotted names, and the
    port's quantized state dict, from the same f32 weights."""
    jq, tq = QUANT[kind]
    ref = JP.flatten_tree(jq(JP.unflatten_tree(flat)))
    return ref, tq(from_jax_params(flat))


# --- the quantized state dicts ----------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("family", ["htdemucs_4s", "hdemucs_mmi"])
def test_quantize_matches_jax_bitwise(family, kind):
    """The full-width state dicts: the same entries quantized, `q` and
    `scale` equal bit for bit, the dense entries equal in f32."""
    schema = (JP.htdemucs_schema(J4S) if family == "htdemucs_4s"
              else JP.hdemucs_v3_schema(JV3))
    flat = JP.init_flat(schema, seed=0)
    ref, ours = _quantized(kind, flat)
    assert set(ours) == set(ref)
    quantized = sorted(k[:-2] for k in ours if k.endswith(".q"))
    assert quantized == sorted(n for n, a in flat.items() if JQ.should_quantize(n, a))
    assert quantized == sorted(n for n, t in from_jax_params(flat).items()
                               if TQ.should_quantize(n, t))
    qdtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    for name in quantized:
        q, scale = ours[f"{name}.q"], ours[f"{name}.scale"]
        assert q.dtype == qdtype and scale.dtype == torch.float32
        assert scale.shape == (q.shape[0],) + (1,) * (q.ndim - 1)
        assert np.array_equal(_bits(q.view(torch.uint8).numpy()),
                              _bits(np.asarray(ref[f"{name}.q"])))
        assert np.array_equal(_bits(scale.numpy()), _bits(np.asarray(ref[f"{name}.scale"])))
    for name in set(flat) - set(quantized):
        assert np.array_equal(ours[name].numpy(), np.asarray(ref[name], np.float32)), name
    dense_bytes = sum(t.numel() * 4 for t in from_jax_params(flat).values())
    assert TQ.quantized_bytes(ours) < 0.45 * dense_bytes  # tests/test_quant.py's bound


def test_fp8_compute_supported_as_jax():
    """The GPU-name rule of `fp8_compute_supported` against the JAX
    package's; on the CPU the port answers False."""

    class FakeDev:
        platform = "gpu"

        def __init__(self, kind):
            self.device_kind = kind

    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                 "Tesla V100-SXM2-16GB", "NVIDIA GeForce RTX 4090", "Quadro RTX 4000",
                 "NVIDIA L4", "NVIDIA L40S", "NVIDIA B200", "Tesla T4"):
        assert TQ._gpu_has_fp8(name) == JQ.fp8_compute_supported(FakeDev(name)), name
    assert TQ._gpu_has_fp8("NVIDIA H100 80GB HBM3")
    assert not TQ.fp8_compute_supported("cpu")


# --- K7's plain twin ---------------------------------------------------------

def test_int8_matmul_plain_matches_pallas():
    """The twin against the Pallas kernel in interpret mode, as
    tests/test_pallas.py runs it. The kernel feeds its matrix unit bf16,
    so x is drawn bf16-representable: the cast is exact (as is int8 ->
    bf16) and only the order of the f32 sums differs, to ~1e-5 relative.
    Then against `int8_linear` with a bias at a ragged M."""
    rng = np.random.default_rng(3)
    M, K, N = 64, 128, 96
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)) * 0.5, jnp.bfloat16), np.float32)
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.1
    scale = np.maximum(np.abs(w).max(1, keepdims=True) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    ref = np.asarray(pallas_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                        jnp.asarray(scale.reshape(-1)), interpret=True))
    before = int8_matmul.launches
    ours = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                       torch.from_numpy(scale.reshape(-1))).numpy()
    assert int8_matmul.launches == before  # CPU tensors: the plain twin
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())

    bias = rng.standard_normal(N).astype(np.float32)
    xr = np.asarray(jnp.asarray(rng.standard_normal((3, 23, K)), jnp.bfloat16), np.float32)
    qleaf = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    ref = np.asarray(int8_linear(jnp.asarray(xr), qleaf, jnp.asarray(bias), interpret=True))
    qw = TO.QuantizedWeight(torch.from_numpy(q), torch.from_numpy(scale))
    ours = TO.linear(torch.from_numpy(xr), qw, torch.from_numpy(bias)).numpy()
    assert ours.shape == ref.shape == (3, 23, N)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(
        int8_matmul_plain(torch.from_numpy(xr.reshape(-1, K)), torch.from_numpy(q),
                          torch.from_numpy(scale.reshape(-1)), torch.from_numpy(bias)).numpy(),
        ours.reshape(-1, N), rtol=0, atol=0)


# --- the quantized models ----------------------------------------------------

def _compare(kind, jcfg, tcfg, schema, segment_fn, length, seed=0):
    flat = JP.init_flat(schema, seed=seed)
    ref_tree, sd = _quantized(kind, flat)
    model = build_model(tcfg, sd, "cpu")
    mix = (np.random.default_rng(42).standard_normal((1, 2, length)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(mix)).numpy()
    qfn = JQ.quantized_model_fn(lambda p, m: segment_fn(p, m, jcfg))
    ref = np.asarray(jax.jit(qfn)(JP.unflatten_tree(ref_tree), jnp.asarray(mix)))
    assert ours.shape == ref.shape == (1, tcfg.num_sources, 2, length)
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max()
    scale = np.abs(ref).max()
    assert diff < TOL * max(scale, 1.0), (diff, scale)
    return model


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_htdemucs_matches_jax(kind):
    """A narrow htdemucs (SMALL) whose every kind of quantized leaf is
    quantized, against `quantized_model_fn(htdemucs_segment)`."""
    jcfg = dataclasses.replace(J4S, **SMALL)
    tcfg = dataclasses.replace(HTDEMUCS_4S, **SMALL)
    schema = JP.htdemucs_schema(jcfg)
    held = {n for n, a in JP.init_flat(schema).items() if JQ.should_quantize(n, a)}
    for leaf in ("crosstransformer.layers.1.cross_attn.in_proj_weight",
                 "crosstransformer.layers_t.0.self_attn.out_proj.weight",
                 "crosstransformer.layers.0.linear1.weight",
                 "crosstransformer.layers.0.linear2.weight",
                 "encoder.3.conv.weight", "tencoder.3.conv.weight", "channel_upsampler.weight",
                 "decoder.0.conv_tr.weight", "tdecoder.0.conv_tr.weight",
                 "encoder.3.dconv.layers.1.0.weight", "tdecoder.0.dconv.layers.0.3.weight"):
        assert leaf in held, leaf
    before = int8_matmul.launches
    model = _compare(kind, jcfg, tcfg, schema, htdemucs_segment, 8192)
    assert int8_matmul.launches == before
    qdtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    for name in held:
        owner, _, attr = name.rpartition(".")
        w = getattr(model.get_submodule(owner), attr)
        assert isinstance(w, TO.QuantizedWeight) and w.q.dtype == qdtype, name


def test_int8_hdemucs_v3_matches_jax():
    """hdemucs_mmi at full width (its schema has no narrow form) on a short
    segment, against `quantized_model_fn(hdemucs_v3_segment)`: the BiLSTM
    output linears run K7's twin, the LocalState and conv weights are
    widened."""
    _compare("int8", JV3, HDEMUCS_V3, JP.hdemucs_v3_schema(JV3), hdemucs_v3_segment, 8192)


def test_int8_modules_hold_int8_and_load_strictly():
    """The quantized weights are int8 buffers on their modules (no f32
    copy), the rest stays dense; a wrong shape or a missing scale fails
    the strict load, and a quantized state dict cannot be trained."""
    cfg = dataclasses.replace(HTDEMUCS_4S, **SMALL)
    schema = JP.htdemucs_schema(dataclasses.replace(J4S, **SMALL))
    sd = TQ.quantize_int8(from_jax_params(JP.init_flat(schema, seed=1)))
    model = build_htdemucs(cfg, sd, "cpu")
    layer = model.crosstransformer.layers[1]
    w = layer.cross_attn.in_proj_weight
    assert isinstance(w, TO.QuantizedWeight)
    assert w.q.dtype == torch.int8 and tuple(w.q.shape) == (192, 64)
    assert w.scale.dtype == torch.float32 and tuple(w.scale.shape) == (192, 1)
    assert torch.equal(w.q, sd["crosstransformer.layers.1.cross_attn.in_proj_weight.q"])
    assert isinstance(layer.norm1.weight, torch.nn.Parameter)
    names = {n for n, _ in model.named_parameters()}
    assert not any(n[:-2] in names for n in sd if n.endswith(".q"))
    assert set(model.state_dict()) == set(sd)

    bad = dict(sd)
    bad["crosstransformer.layers.0.linear1.weight.q"] = torch.zeros(256, 63, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="linear1.weight.q"):
        build_htdemucs(cfg, bad, "cpu")
    bad = dict(sd)
    bad.pop("encoder.3.conv.weight.scale")
    with pytest.raises(RuntimeError, match="encoder.3.conv.weight.scale"):
        build_htdemucs(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="inference"):
        build_htdemucs(cfg, sd, "cpu", train=True)


def test_int8_cli_matches_jax_cli(tmp_path):
    """Both CLIs with --int8 on the same WAV and full-width htdemucs-4s
    weights (16384-sample segments, pinned shift) write matching stems;
    --int8 beside --fp8 still quantizes to int8, as in the JAX CLI."""
    model = tmp_path / "4s.bin"
    JP.write_ggml(model, "htdemucs_4s", JP.init_flat(JP.htdemucs_schema(J4S), seed=0))
    wav = tmp_path / "in.wav"
    JAud.write_wav(wav, _rand(2, 20000, seed=3, scale=0.2))
    common = ["--offset", "1337", "--batch", "2", "--segment-samples", "16384", "--int8"]
    assert torch_main([str(model), str(wav), str(tmp_path / "port"), "--device", "cpu",
                       "--fp8"] + common) == 0
    assert jax_main([str(model), str(wav), str(tmp_path / "jax"), "--no-mesh"] + common) == 0
    for i, name in enumerate(J4S.sources):
        stem = f"target_{i}_{name}.wav"
        ours, rate = TAud.read_wav(tmp_path / "port" / stem)
        ref, _ = TAud.read_wav(tmp_path / "jax" / stem)
        assert rate == 44100 and ours.shape == ref.shape == (2, 20000)
        assert np.isfinite(ours).all()
        err = np.abs(ours - ref).max()
        assert err <= TOL * max(np.abs(ref).max(), 1.0), (name, err)

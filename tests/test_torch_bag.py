"""demucs_tpu_torch's fine-tuned bag (htdemucs_ft: `models.BagOfModels`,
`pipeline.SequentialBagSeparator`, the CLI's `--ft-dir`) against
demucs_tpu's on the CPU.

The bag is four htdemucs-4s models with one stem each: model i gives
stem i. The JAX package stacks the four trees and maps the segment graph
over the models axis (`models/bag.py`); the port keeps four modules and
takes stem i of model i as it goes. Both compute the same numbers, so the
module is held to 1e-5 of max(scale, 1), as tests/test_torch_model.py
holds one model, in f32 and with int8 weights (quantized per model, then
stacked, as the CLI does); with bf16 weights to the bounds of
tests/test_torch_bf16.py. The CLIs run four full-width files (random
weights, `init_flat` seeds 0-3) on a short track.

Weights come from `init_flat` with seeds 0-3, inputs from numpy seeds.

    python -m pytest -q tests/test_torch_bag.py
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
from demucs_tpu import pipeline as JPipe
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.models import htdemucs_segment
from demucs_tpu.models import bag as JBag
from demucs_tpu.params import quant as JQ

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import cli as TCli
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import BagOfModels, bag_select, build_bag, unrolled_model_map
from demucs_tpu_torch.params import (cast_state_dict, from_jax_bag_params, from_jax_params,
                                     quantize_int8)
from demucs_tpu_torch.pipeline import (PCM16_TRANSFER_SCALE, ApplyOptions,
                                       SequentialBagSeparator, Separator)

from _torch_threads import _one_torch_thread  # noqa: F401

BF16 = jnp.bfloat16
TOL = 1e-5              # of max(scale, 1)
JAX_BF16_BOUND = 0.08   # ||bf16 - f32|| / ||f32||, tests/test_model_v4.py
STEP = 1.0 / PCM16_TRANSFER_SCALE   # one int16 transfer step
# a narrow htdemucs-4s in which every kind of quantized leaf still reaches
# the quantizer's 4096 elements (tests/test_torch_quant.py)
SMALL = dict(channels=16, bottom_channels=64, t_layers=2)
JCFG = dataclasses.replace(J4S, **SMALL)
TCFG = dataclasses.replace(HTDEMUCS_4S, **SMALL)
MODES = ("f32", "int8", "bf16")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1.0), (err, scale)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _flats() -> tuple:
    """The four narrow models' weights in f32 (init_flat leaves some in f64)."""
    return tuple({k: np.asarray(v, np.float32)
                  for k, v in JP.init_flat(JP.htdemucs_schema(JCFG), seed=s).items()}
                 for s in range(4))


@functools.lru_cache(maxsize=None)
def _jax_trees(mode: str) -> tuple:
    """Each model's JAX tree as the JAX CLI makes it for `mode`: f32, int8
    (`quantize_int8` per tree) or bf16 (every leaf cast)."""
    trees = [JP.unflatten_tree(f) for f in _flats()]
    if mode == "int8":
        return tuple(JQ.quantize_int8(t) for t in trees)
    if mode == "bf16":
        # the CLI's cast, jitted once for the tree rather than dispatched
        # (and compiled) leaf by leaf
        cast = jax.jit(lambda t: jax.tree.map(lambda x: jnp.asarray(x, BF16), t))
        return tuple(cast(t) for t in trees)
    return tuple(trees)


# stack_bag_params jitted once per tree structure (eagerly it compiles a
# stack for every leaf shape)
_stack = jax.jit(JBag.stack_bag_params)


@functools.lru_cache(maxsize=None)
def _mix() -> np.ndarray:
    return _rand(2, 2, 8192, seed=42, scale=0.1)


@functools.lru_cache(maxsize=None)
def _jax_bag(mode: str) -> np.ndarray:
    """The JAX bag on the stacked trees: `bag_select` over
    `unrolled_model_map` of one jitted model (`htdemucs_segment`; with int8
    trees `quantized_model_fn(htdemucs_segment)`, the CLI's model
    function), which is `bag_segment`'s computation with one model's graph
    compiled, not the bag's four; the CLI tests below run the JAX CLI's
    jitted four-model bag."""
    stacked = _stack(list(_jax_trees(mode)))
    mix = jnp.asarray(_mix())
    single = lambda p, m: htdemucs_segment(p, m, JCFG)  # noqa: E731
    if mode == "int8":
        single = JQ.quantized_model_fn(single)
    single = jax.jit(single)
    per_model = JBag.unrolled_model_map(lambda p: single(p, mix), stacked)
    return np.asarray(JBag.bag_select(per_model), np.float32)


# --- weights across ------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", MODES)
def test_from_jax_bag_params_carries_the_stacked_tree_bitwise(mode):
    """Each model's slice of the stacked tree equals the model's own tree
    carried by `from_jax_params`, bit for bit and in its dtype: f32, bf16,
    and int8 `q` with f32 `scale`, which are also the port's own
    quantization of the model's f32 weights."""
    trees = _jax_trees(mode)
    ours = from_jax_bag_params(_stack(list(trees)))
    assert len(ours) == 4
    for i, (sd, tree) in enumerate(zip(ours, trees)):
        ref = from_jax_params(tree)
        assert set(sd) == set(ref)
        assert all(_same(sd[k], ref[k]) for k in ref), i
        if mode == "int8":
            own = quantize_int8(from_jax_params(_flats()[i]))
            assert {k for k, t in sd.items() if t.dtype == torch.int8} == \
                {k for k in own if k.endswith(".q")}
            assert all(_same(sd[k], own[k]) for k in own), i
        if mode == "bf16":
            assert {t.dtype for t in sd.values()} == {torch.bfloat16}


def test_from_jax_bag_params_refuses_ragged_models_axes():
    with pytest.raises(ValueError, match="leading"):
        from_jax_bag_params({"a": np.zeros((4, 3)), "b": np.zeros((3, 3))})


def test_bag_select_and_unrolled_model_map_match_jax_bitwise():
    per_model = _rand(4, 2, 4, 2, 33, seed=7)
    ref = np.asarray(JBag.bag_select(jnp.asarray(per_model)))
    ours = bag_select(torch.from_numpy(per_model)).numpy()
    assert ours.shape == ref.shape == (2, 4, 2, 33)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="stems"):
        bag_select(torch.zeros(3, 1, 4, 2, 5))
    models = [_Scalar(m + 1.0) for m in range(4)]
    mix = torch.from_numpy(_rand(2, 2, 17, seed=8))
    stacked = unrolled_model_map(models, mix)
    assert stacked.shape == (4, 2, 4, 2, 17)
    np.testing.assert_array_equal(bag_select(stacked).numpy(), BagOfModels(models)(mix).numpy())


# --- the bag module ------------------------------------------------------------

def _port_bag(mode: str) -> np.ndarray:
    trees = _jax_trees("int8" if mode == "int8" else "f32")
    sds = from_jax_bag_params(_stack(list(trees)))
    if mode == "bf16":
        sds = [cast_state_dict(sd, torch.bfloat16) for sd in sds]
    bag = build_bag(TCFG, sds, "cpu")
    with torch.inference_mode():
        out = bag(torch.from_numpy(_mix()))
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_bag_module_matches_jax_bag_segment(mode):
    """BagOfModels of four narrow htdemucs-4s models against the JAX bag
    (`bag_select` of `unrolled_model_map`) on the stacked trees: f32 and int8 (each tree quantized, then stacked)
    within 1e-5 of max(scale, 1); bf16 within 0.08 of the JAX f32 bag and
    no further from the JAX bf16 bag than twice its own bf16 error."""
    ours = _port_bag(mode)
    assert ours.shape == (2, 4, 2, 8192)
    if mode != "bf16":
        _close(ours, _jax_bag(mode), TOL)
        return
    ref32, ref16 = _jax_bag("f32"), _jax_bag("bf16")
    assert np.isfinite(ours).all()
    assert _rel(ours, ref32) < JAX_BF16_BOUND, _rel(ours, ref32)
    noise = np.linalg.norm(ref16 - ref32)
    assert np.linalg.norm(ours - ref16) <= 2 * noise, (np.linalg.norm(ours - ref16), noise)


def test_build_bag_checks_its_models():
    """Every model is built with the first one's config: a state dict of
    another width fails its strict load with the model's index; a bag
    needs as many models as stems."""
    sds = [from_jax_params(f) for f in _flats()]
    wide = dataclasses.replace(JCFG, channels=24)
    sds[2] = from_jax_params(JP.init_flat(JP.htdemucs_schema(wide), seed=2))
    with pytest.raises(ValueError, match="bag model 2"):
        build_bag(TCFG, sds, "cpu")
    with pytest.raises(ValueError, match="needs 4"):
        build_bag(TCFG, sds[:3], "cpu")


# --- SequentialBagSeparator ----------------------------------------------------

class _Scalar(torch.nn.Module):
    """tests/test_pipeline.py's toy bag model: a scalar weight per model,
    stem i = mix * w * (i + 1)."""

    def __init__(self, w: float):
        super().__init__()
        self.w = w

    def forward(self, mix):
        return torch.stack([mix * self.w * (i + 1) for i in range(4)], dim=1)


def _jax_scalar(params, mix):
    return jnp.stack([mix * params["w"] * (i + 1) for i in range(4)], axis=1)


@pytest.mark.parametrize("fused", [False, True], ids=["batched", "fused"])
def test_sequential_bag_matches_separator_of_the_bag_and_jax(fused):
    """The port's SequentialBagSeparator on the batched path equals
    Separator(BagOfModels) bit for bit; its fused form (one upload, every
    model on each group of segments, stem i of model i downloaded) matches
    it within 2e-5, as tests/test_pipeline.py holds the JAX forms; both match the
    JAX SequentialBagSeparator on the same toy, also through
    separate_many."""
    audio = _rand(2, 20000, seed=11, scale=0.3)
    opts = ApplyOptions(segment_samples=4096, batch_size=4, shift_offset=0,
                        fused_track=fused)
    models = [_Scalar(m + 1.0) for m in range(4)]
    seq = SequentialBagSeparator(models, 4, opts, "cpu")
    ref = Separator(BagOfModels(models), 4, dataclasses.replace(opts, fused_track=False),
                    "cpu")(audio)
    out = seq(audio)
    assert out.shape == ref.shape == (4, 2, 20000) and out.dtype == np.float32
    if fused:
        np.testing.assert_allclose(out, ref, atol=2e-5)
    else:
        np.testing.assert_array_equal(out, ref)
    jopts = JPipe.ApplyOptions(segment_samples=4096, batch_size=4, shift_offset=0,
                               fused_track=fused)
    jax_seq = JPipe.SequentialBagSeparator(_jax_scalar, [{"w": jnp.asarray(m + 1.0)}
                                                         for m in range(4)], 4, jopts)
    np.testing.assert_allclose(out, jax_seq(audio), atol=2e-5)
    short = _rand(2, 9000, seed=12, scale=0.3)
    for got, want in zip(seq.separate_many([audio, short]), [out, seq(short)]):
        np.testing.assert_allclose(got, want, atol=2e-5 if fused else 0)


# --- the CLIs --------------------------------------------------------------------

N_TRACK = 12000
COMMON = ["--offset", "1337", "--batch", "2", "--segment-samples", "8192"]


@pytest.fixture(scope="module")
def ft_dir(tmp_path_factory):
    """Four full-width htdemucs-4s files, seeds 0-3, named as the reference
    names the fine-tuned bag's, and a short track."""
    root = tmp_path_factory.mktemp("ft")
    models = root / "models"
    models.mkdir()
    for i, stem in enumerate(J4S.sources):
        JP.write_ggml(models / f"htdemucs_ft_{stem}.bin", "htdemucs_4s",
                      JP.init_flat(JP.htdemucs_schema(J4S), seed=i))
    (models / "README.txt").write_text("not a model")
    JAud.write_wav(root / "in.wav", _rand(2, N_TRACK, seed=3, scale=0.2))
    return root


def _stems(outdir, n=N_TRACK):
    out = []
    for i, name in enumerate(J4S.sources):
        stem, rate = TAud.read_wav(outdir / f"target_{i}_{name}.wav")
        assert rate == 44100 and stem.shape == (2, n) and np.isfinite(stem).all()
        out.append(stem)
    return np.stack(out)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["dense", "int8"])
def test_ft_dir_cli_matches_jax_cli(ft_dir, tmp_path, quant):
    """Both CLIs with --ft-dir on four full-width files: the port's stems
    within 1e-5 of max(scale, 1) of the JAX CLI's, dense and with --int8
    (each model quantized on its own)."""
    args = ["--ft-dir", str(ft_dir / "models"), str(ft_dir / "in.wav")]
    extra = COMMON + ([f"--{quant}"] if quant else [])
    assert TCli.main(args + [str(tmp_path / "port"), "--device", "cpu"] + extra) == 0
    assert jax_main(args + [str(tmp_path / "jax"), "--no-mesh"] + extra) == 0
    _close(_stems(tmp_path / "port"), _stems(tmp_path / "jax"), TOL)


def test_ft_dir_cli_fused_int16_on_a_directory(ft_dir, tmp_path):
    """--ft-dir --fused --transfer-int16 on a directory of two tracks runs
    the bag through separate_many: one folder per track, each within one
    int16 step (of the track's std) and the fused pass's f32 sums of the
    bag's default path."""
    tracks = tmp_path / "tracks"
    tracks.mkdir()
    x = TAud.load_track(ft_dir / "in.wav")
    JAud.write_wav(tracks / "a.wav", x)
    JAud.write_wav(tracks / "b.wav", x[:, :9000])
    models = ["--ft-dir", str(ft_dir / "models")]
    assert TCli.main(models + [str(tracks), str(tmp_path / "fused"), "--device", "cpu",
                               "--fused", "--transfer-int16", "--pipeline-depth", "1"]
                     + COMMON) == 0
    assert TCli.main(models + [str(ft_dir / "in.wav"), str(tmp_path / "ref"),
                               "--device", "cpu"] + COMMON) == 0
    ref = _stems(tmp_path / "ref")
    got = _stems(tmp_path / "fused" / "a")
    _stems(tmp_path / "fused" / "b", 9000)
    std = float(x.mean(0).std(ddof=1))
    assert np.abs(got - ref).max() <= STEP * max(std, 1.0) + 3e-5


def test_find_ft_models_and_the_cli_refusals(tmp_path, capsys):
    """Files are found by substring, the first sorted match per stem in the
    order drums, bass, other, vocals; a missing stem is an error; `model`
    and --ft-dir together, or neither, are refused."""
    d = tmp_path / "ft"
    d.mkdir()
    for name in ("x_htdemucs_ft_vocals.bin", "htdemucs_ft_drums_b.bin",
                 "htdemucs_ft_drums_a.bin", "htdemucs_ft_bass.bin", "htdemucs_ft_other.th"):
        (d / name).write_bytes(b"")
    assert [p.name for p in TCli._find_ft_models(d)] == [
        "htdemucs_ft_drums_a.bin", "htdemucs_ft_bass.bin", "htdemucs_ft_other.th",
        "x_htdemucs_ft_vocals.bin"]
    (d / "x_htdemucs_ft_vocals.bin").unlink()
    with pytest.raises(FileNotFoundError, match="htdemucs_ft_vocals"):
        TCli._find_ft_models(d)
    wav = tmp_path / "in.wav"
    TAud.write_wav(wav, np.zeros((2, 100), np.float32))
    assert TCli.main(["--ft-dir", str(d), str(wav), str(tmp_path / "o"),
                      "--device", "cpu"]) == 1
    assert "no htdemucs_ft_vocals model" in capsys.readouterr().err
    for argv in (["m.bin", str(wav), str(tmp_path), "--ft-dir", str(d)],
                 [str(wav), str(tmp_path)]):
        with pytest.raises(SystemExit):
            TCli.main(argv + ["--device", "cpu"])
        assert "exactly one of `model` or --ft-dir" in capsys.readouterr().err

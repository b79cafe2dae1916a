"""demucs_tpu_torch's last tools against the JAX package's, on the CPU:
the checkpoint converter (`tools/convert_pth_to_ggml.py`), the torch
oracle models (`tools/torch_ref.py`, `torch_ref_v3.py`), the oracle's
track inference (`tools/torch_inference.py`) and the SDR acceptance gate
(`tools/sdr_acceptance.py`).

The converter writes byte-identical ggml files for every checkpoint form
and kind, and with `--orbax` a checkpoint directory holding exactly the
weights of the JAX tool's Orbax directory; the oracles equal the JAX
package's bit for bit and agree with the port's segment models; the
oracle's stems through the port's `Separator` equal the JAX tool's; the
gate passes the port against the oracle, with and without ground truth,
and fails where the two disagree. Full width, short tracks (16384-sample
segments); every file is written under a temporary directory that the
test removes."""

import argparse
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from demucs_tpu import params as JP
from demucs_tpu.params.ggml import load_model_params as jax_load_model_params
from demucs_tpu.tools import convert_pth_to_ggml as j_convert
from demucs_tpu.tools import sdr_acceptance as j_accept
from demucs_tpu.tools import torch_inference as j_infer
from demucs_tpu.tools import torch_ref as j_ref
from demucs_tpu.tools import torch_ref_v3 as j_ref_v3

from demucs_tpu_torch import audio
from demucs_tpu_torch import params as P
from demucs_tpu_torch.cli import main as cli_main
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S, HTDEMUCS_6S
from demucs_tpu_torch.models import build_model
from demucs_tpu_torch.params.checkpoint_io import load_flat
from demucs_tpu_torch.tools import convert_pth_to_ggml, sdr_acceptance, torch_inference
from demucs_tpu_torch.tools.torch_ref import HTDemucsRef
from demucs_tpu_torch.tools.torch_ref_v3 import HDemucsV3Ref

from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 16384
KINDS = {"htdemucs_4s": HTDEMUCS_4S, "htdemucs_6s": HTDEMUCS_6S, "hdemucs_mmi": HDEMUCS_V3}
FORMS = ("module", "state", "models", "raw")


def _schema(kind: str) -> dict:
    cfg = KINDS[kind]
    return P.hdemucs_v3_schema(cfg) if kind == "hdemucs_mmi" else P.htdemucs_schema(cfg)


@pytest.fixture
def work():
    """A temporary directory, removed after the test (full-width files)."""
    path = Path(tempfile.mkdtemp(prefix="torch_accept_"))
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def v4_model():
    """A full-width htdemucs-4s ggml file (init_flat seed 0), removed at the
    module's end."""
    path = Path(tempfile.mkdtemp(prefix="torch_accept_model_"))
    P.write_ggml(path / "m.bin", "htdemucs_4s", P.init_flat(_schema("htdemucs_4s"), seed=0))
    yield path / "m.bin"
    shutil.rmtree(path, ignore_errors=True)


def _write_track(path: Path, n: int, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    audio.write_wav(path, (rng.standard_normal((2, n)) * 0.2).astype(np.float32))
    return path


def _stems(d: Path, sources) -> np.ndarray:
    return np.stack([audio.read_wav(d / f"target_{i}_{s}.wav")[0] for i, s in enumerate(sources)])


# ------------------------------------------------------------- converter

def _module_of(sd: dict) -> nn.Module:
    """A plain nn.Module tree whose state_dict() is `sd` (dotted names as
    nested submodules), as a checkpoint that pickles a whole model."""
    root = nn.Module()
    for name, arr in sd.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        node.register_parameter(leaf, nn.Parameter(torch.from_numpy(arr), requires_grad=False))
    return root


def _checkpoint(form: str, sd: dict):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    return {"module": lambda: _module_of(sd), "state": lambda: {"state": tensors},
            "models": lambda: {"models": [_module_of(sd)]}, "raw": lambda: tensors}[form]()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("form", FORMS)
def test_converter_writes_the_jax_tools_bytes(work, form, kind):
    """Every checkpoint form, every --kind: the same ggml bytes as the JAX
    tool. The schema's tensors of up to 2^14 elements (biases, norms,
    LayerScales, the small convolutions, some with a unit axis to squeeze),
    f32 values the fp16 store rounds."""
    schema = {k: s for k, s in _schema(kind).items() if np.prod(s) <= 2 ** 14}
    sd = P.init_flat(schema, seed=3)
    assert any(1 in s for s in schema.values()) and len(sd) > 20
    ckpt = work / "model.th"
    torch.save(_checkpoint(form, sd), ckpt)
    assert convert_pth_to_ggml.main([str(ckpt), str(work / "port.bin"), "--kind", kind]) == 0
    assert j_convert.main([str(ckpt), str(work / "jax.bin"), "--kind", kind]) == 0
    port = (work / "port.bin").read_bytes()
    assert port == (work / "jax.bin").read_bytes()
    got_kind, tensors = P.load_ggml(port)
    assert got_kind == kind and set(tensors) == set(sd)
    for name, arr in sd.items():
        np.testing.assert_array_equal(tensors[name], np.squeeze(arr).astype(np.float16))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_converter_orbax_directory_holds_the_jax_tools_weights(work, kind):
    """--orbax: the port's checkpoint directory, loaded by the port, equals
    the JAX tool's Orbax directory loaded by the JAX package, exactly, and
    both the fp16-rounded checkpoint at the schema's full shapes."""
    schema = _schema(kind)
    sd = P.init_flat(schema, seed=6)
    ckpt = work / "full.th"
    torch.save({"state": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    assert convert_pth_to_ggml.main([str(ckpt), str(work / "port"), "--kind", kind,
                                     "--orbax"]) == 0
    assert j_convert.main([str(ckpt), str(work / "jax"), "--kind", kind, "--orbax"]) == 0
    ckpt.unlink()
    assert all(t.dtype == torch.float16 for t in load_flat(work / "port").values())
    cfg, port = P.load_model_params(work / "port")
    jcfg, jtree = jax_load_model_params(work / "jax")
    jflat = JP.flatten_tree(jtree)
    assert cfg == KINDS[kind] and jcfg.sources == cfg.sources
    assert list(port) == list(schema) and set(jflat) == set(schema)
    for name, shape in schema.items():
        want = sd[name].astype(np.float16).astype(np.float32)
        assert tuple(port[name].shape) == tuple(shape)
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(jflat[name], np.float32))
        np.testing.assert_array_equal(port[name].numpy(), want)


# ------------------------------------------------------------- oracles

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_oracles_equal_the_jax_packages_and_the_port(kind):
    """One full-width segment of 16384 samples: the port's oracle equals the
    JAX package's bit for bit (the same torch arithmetic on the CPU) and
    agrees with the port's segment model within 1e-5 of scale."""
    cfg, schema = KINDS[kind], _schema(kind)
    sd = P.from_state_dict(P.init_flat(schema, seed=1), schema)
    port_cls, jax_cls = ((HDemucsV3Ref, j_ref_v3.HDemucsV3Ref) if kind == "hdemucs_mmi"
                         else (HTDemucsRef, j_ref.HTDemucsRef))
    rng = np.random.default_rng(2)
    mix = torch.from_numpy((rng.standard_normal((1, 2, SEG)) * 0.2).astype(np.float32))
    oracle, jax_oracle = port_cls(cfg), jax_cls(cfg)
    for model in (oracle, jax_oracle):
        model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        oracle, jax_oracle, port = (model.eval()(mix) for model in (
            oracle, jax_oracle, build_model(cfg, sd, "cpu")))
    assert oracle.shape == (1, cfg.num_sources, 2, SEG)
    assert torch.equal(oracle, jax_oracle)
    scale = oracle.abs().max().item()
    assert (port - oracle).abs().max().item() <= 1e-5 * scale


def test_oracle_runs_with_tf32_off():
    """torch_inference's oracle runs inside f32_precision: the TF32 flags
    are off in its forward and back on after it."""
    seen = []

    class Probe(nn.Module):
        def forward(self, x):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return x

    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    was = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        torch_inference.F32Oracle(Probe())(torch.zeros(1))
        assert seen == [(False, False)]
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, w in zip(flags, was):
            f.allow_tf32 = w


@pytest.mark.parametrize("kind", ["htdemucs_4s", "hdemucs_mmi"])
def test_torch_inference_matches_the_jax_tool_and_the_cli(work, kind):
    """The JAX test's files (20000 samples, segment 16384, offset 0): the
    port's oracle tool equals the JAX tool within 1e-6 of scale, and the
    port's CLI on the CPU within 1e-3 relative."""
    cfg = KINDS[kind]
    model = work / "m.bin"
    P.write_ggml(model, kind, P.init_flat(_schema(kind), seed=0))
    wav = _write_track(work / "in.wav", 20000, 5)
    args = [str(model), str(wav), None, "--offset", "0", "--segment-samples", str(SEG)]
    runs = {"port": (torch_inference.main, ["--device", "cpu"]), "jax": (j_infer.main, []),
            "cli": (cli_main, ["--device", "cpu", "--batch", "2"])}
    out = {}
    for name, (main, extra) in runs.items():
        argv = list(args)
        argv[2] = str(work / name)
        assert main(argv + extra) == 0
        out[name] = _stems(work / name, cfg.sources)
    assert out["port"].shape == (cfg.num_sources, 2, 20000)
    scale = np.abs(out["jax"]).max()
    assert np.abs(out["port"] - out["jax"]).max() <= 1e-6 * scale
    for i, name in enumerate(cfg.sources):
        err = np.linalg.norm(out["cli"][i] - out["port"][i]) / np.linalg.norm(out["port"][i])
        assert err < 1e-3, (name, err)


# ------------------------------------------------------------- the gate

def _accept(argv, capsys) -> tuple[int, dict]:
    rc = sdr_acceptance.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sdr_acceptance_passes_without_ground_truth(work, v4_model, capsys):
    """Default branch: the port against the oracle on a 66150-sample track
    at segment 16384, every stem far above the 30 dB gate (> 40 dB); the
    stems stay in --workdir."""
    wav = _write_track(work / "in.wav", 66150, 9)
    rc, rep = _accept([str(v4_model), str(wav), "--workdir", str(work / "w"),
                       "--segment-samples", str(SEG), "--device", "cpu"], capsys)
    assert rc == 0 and rep["pass"], rep
    assert set(rep) == {*HTDEMUCS_4S.sources, "pass"}
    for stem in HTDEMUCS_4S.sources:
        assert rep[stem]["cross_impl_sdr_db"] > 40, rep
        assert set(rep[stem]) == {"cross_impl_sdr_db"}
    assert len(list((work / "w" / "port").glob("*.wav"))) == 4
    assert len(list((work / "w" / "torch").glob("*.wav"))) == 4


def test_sdr_acceptance_with_ground_truth(work, v4_model, capsys):
    """--ref-dir: ground truth is the oracle's stems plus seeded noise; the
    port and the oracle score within 0.1 dB of each other per stem, with
    the JAX tool's keys (jax_sdr_db named port_sdr_db)."""
    wav = _write_track(work / "in.wav", 66150, 9)
    assert torch_inference.main([str(v4_model), str(wav), str(work / "oracle"),
                                 "--segment-samples", str(SEG), "--device", "cpu"]) == 0
    refs = work / "refs"
    refs.mkdir()
    rng = np.random.default_rng(13)
    for stem, est in zip(HTDEMUCS_4S.sources, _stems(work / "oracle", HTDEMUCS_4S.sources)):
        noise = rng.standard_normal(est.shape).astype(np.float32) * 0.1 * est.std()
        audio.write_wav(refs / f"{stem}.wav", est + noise)
    rc, rep = _accept([str(v4_model), str(wav), "--ref-dir", str(refs),
                       "--segment-samples", str(SEG), "--device", "cpu"], capsys)
    assert rc == 0 and rep["pass"], rep
    for stem in HTDEMUCS_4S.sources:
        entry = rep[stem]
        assert set(entry) == {"cross_impl_sdr_db", "port_sdr_db", "torch_sdr_db", "delta_db"}
        assert abs(entry["port_sdr_db"] - entry["torch_sdr_db"]) <= 0.1, rep
        assert entry["delta_db"] <= 0.1 and 15 < entry["torch_sdr_db"] < 25, rep


def test_sdr_acceptance_ft_bag(work, capsys):
    """--ft-dir: the port's bag against the oracle bag, per stem (stem i
    from model i), four full-width models of distinct seeds."""
    mdir = work / "models"
    mdir.mkdir()
    for i, stem in enumerate(HTDEMUCS_4S.sources):
        P.write_ggml(mdir / f"ggml-model-htdemucs_ft_{stem}-f16.bin", "htdemucs_4s",
                     P.init_flat(_schema("htdemucs_4s"), seed=10 + i))
    wav = _write_track(work / "in.wav", 66150, 11)
    rc, rep = _accept(["--ft-dir", str(mdir), str(wav), "--segment-samples", str(SEG),
                       "--device", "cpu"], capsys)
    assert rc == 0 and rep["pass"], rep
    for stem in HTDEMUCS_4S.sources:
        assert rep[stem]["cross_impl_sdr_db"] > 40, rep


def test_sdr_gate_fails_on_disagreement_and_nan(work):
    """The gate itself: a stem 20 dB off the oracle fails the 30 dB cross
    gate; with ground truth, a 3.5 dB difference fails the 0.1 dB tolerance;
    a track shorter than one 1 s window (NaN SDR) fails both."""
    rng = np.random.default_rng(4)
    sources = HTDEMUCS_4S.sources

    def write(d, stems):
        d.mkdir(parents=True, exist_ok=True)
        for i, (s, x) in enumerate(zip(sources, stems)):
            audio.write_wav(d / f"target_{i}_{s}.wav", x.astype(np.float32))

    ref = rng.standard_normal((4, 2, 88200))
    write(work / "torch", ref)
    write(work / "same", ref)
    write(work / "off", ref + 0.1 * rng.standard_normal(ref.shape))
    assert sdr_acceptance.gate(work / "same", work / "torch", sources, None, 0.1)["pass"]
    rep = sdr_acceptance.gate(work / "off", work / "torch", sources, None, 0.1)
    assert not rep["pass"] and all(19 < rep[s]["cross_impl_sdr_db"] < 21 for s in sources)
    # ground truth: the oracle scores 20 dB, the "port" 3.5 dB less
    write(work / "gt", ref + 0.1 * rng.standard_normal(ref.shape))
    write(work / "worse", ref + 0.112 * rng.standard_normal(ref.shape))
    rep = sdr_acceptance.gate(work / "worse", work / "torch", sources, str(work / "gt"), 0.1)
    assert not rep["pass"] and all(rep[s]["delta_db"] > 0.5 for s in sources), rep
    write(work / "short_t", ref[..., :22050])
    write(work / "short_p", ref[..., :22050])
    rep = sdr_acceptance.gate(work / "short_p", work / "short_t", sources, None, 0.1)
    assert not rep["pass"] and rep[sources[0]]["cross_impl_sdr_db"] is None


# ------------------------------------------------------------- command lines

class _Parsed(Exception):
    pass


def _flags(main, monkeypatch) -> dict:
    """{option: default} of the parser `main` builds, stopped before it
    parses."""
    def stop(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as caught:
            main([])
    parser = caught.value.args[0]
    return {a.option_strings[0] if a.option_strings else a.dest: a.default
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax", [(convert_pth_to_ggml, j_convert),
                                      (torch_inference, j_infer),
                                      (sdr_acceptance, j_accept)],
                         ids=["convert_pth_to_ggml", "torch_inference", "sdr_acceptance"])
def test_command_lines_are_the_jax_tools(port, jax, monkeypatch):
    """Each tool takes every argument of the JAX tool with its default,
    and `--device` (default cuda) beside them where it runs a model."""
    port_flags, jax_flags = _flags(port.main, monkeypatch), _flags(jax.main, monkeypatch)
    extra = {k: v for k, v in port_flags.items() if k not in jax_flags}
    assert {k: port_flags[k] for k in jax_flags} == jax_flags
    assert extra == ({} if port is convert_pth_to_ggml else {"--device": "cuda"})

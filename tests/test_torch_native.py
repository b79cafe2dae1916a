"""demucs_tpu_torch's native helpers (`native/ggml_loader.cpp`,
`native/wav_io.cpp`, built with g++ into `demucs_tpu_torch/_build/`)
against the JAX package's native and numpy paths on the CPU, bit for bit:
the ggml parser on full-width htdemucs-4s and hdemucs_mmi files (deleted
after use), its refusals of bad and truncated files, the fp16 widening
at its edge values, the WAV decode of PCM 8/16/24/32 and float32/64,
mono and stereo, and the PCM16 encode's bytes; then the fallback rules:
numpy only where g++ is missing (`native.FALLBACK`), a failed build
raises, and a corrupt file raises ValueError on either path."""

import shutil

import numpy as np
import pytest

from demucs_tpu import audio as JAud
from demucs_tpu import params as JP
from demucs_tpu.config import HDEMUCS_V3 as JV3, HTDEMUCS_4S as J4S
from demucs_tpu.params import ggml as JG
from demucs_tpu.params import native_ggml as JN

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import native
from demucs_tpu_torch.params import ggml as TG
from demucs_tpu_torch.params import native_ggml as TN

from _torch_threads import _one_torch_thread  # noqa: F401
from test_native import _write_pcm


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind,schema", [("htdemucs_4s", JP.htdemucs_schema(J4S)),
                                         ("hdemucs_mmi", JP.hdemucs_v3_schema(JV3))],
                         ids=["4s", "v3"])
def test_native_parser_matches_jax_on_full_width_files(tmp_path, kind, schema):
    path = tmp_path / f"{kind}.bin"
    JG.write_ggml(path, kind, JP.init_flat(schema, seed=0))
    try:
        data = path.read_bytes()
    finally:
        path.unlink()  # full-width files are large
    refs = [JN.load(data), JG._load_ggml_numpy(data)]
    for got in (TN.load(data), TG.load_ggml(data)):
        for ref_kind, ref in refs:
            assert got[0] == ref_kind == kind
            assert list(got[1]) == list(ref)
            for name, arr in ref.items():
                assert _same_bits(got[1][name], arr), name
    assert not native.FALLBACK and native.library_path("ggml_loader").exists()


def test_native_parser_refuses_bad_files(tmp_path):
    path = tmp_path / "m.bin"
    TG.write_ggml(path, "htdemucs_4s", {"a.w": np.ones((4, 4), np.float16)})
    data = path.read_bytes()
    for load in (TN.load, TG.load_ggml):
        with pytest.raises(ValueError, match="magic"):
            load(b"XXXX" + b"\x00" * 16)
        for cut in (2, 7, 15, len(data) - 3):
            with pytest.raises(ValueError, match="ggml"):
                load(data[:cut])


def test_fp16_to_fp32_exact_at_the_edges():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float16)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 6e-8, -6e-8,
                     65504.0, -65504.0, 5.96e-8], dtype=np.float16)
    x = np.concatenate([x, edge])
    out = TN.fp16_to_fp32(x)
    assert _same_bits(out, x.astype(np.float32))
    assert _same_bits(out, JN.fp16_to_fp32(x))


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("dtype,bits", [("int", 8), ("int", 16), ("int", 24), ("int", 32),
                                        ("float", 32), ("float", 64)])
def test_wav_decode_matches_jax(tmp_path, dtype, bits, channels):
    data = (np.random.default_rng(3).standard_normal((channels, 1713)) * 0.5
            ).astype(np.float32)
    path = _write_pcm(tmp_path, f"t{bits}{dtype}.wav", dtype, bits, data)
    got, rate = TAud.read_wav(path)
    assert rate == 44100 and got.shape == (channels, 1713)
    for ref, ref_rate in (JAud.read_wav(path), JAud.read_wav(path, native=False),
                          TAud.read_wav(path, native=False)):
        assert ref_rate == rate and _same_bits(got, ref)


def test_pcm16_encode_matches_jax(tmp_path):
    x = (np.random.default_rng(4).standard_normal((2, 4411)) * 0.4).astype(np.float32)
    x[0, :6] = [1.5, -1.5, 1.0, -1.0, 0.5 / 32767, -1.5 / 32767]  # clips and ties
    TAud.write_wav(tmp_path / "port.wav", x, pcm16=True)
    JAud.write_wav(tmp_path / "jax.wav", x, pcm16=True)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert not native.FALLBACK and native.library_path("wav_io").exists()


def test_corrupt_wav_raises_on_both_paths(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunk")
    for use_native in (True, False):
        with pytest.raises(ValueError):
            TAud.read_wav(bad, native=use_native)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The native helpers with nothing loaded and an empty build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "FALLBACK", False)
    return tmp_path


def test_numpy_fallback_only_without_gxx(fresh_build, monkeypatch):
    path = fresh_build / "m.bin"
    flat = {"a.w": np.arange(12, dtype=np.float16).reshape(3, 4)}
    TG.write_ggml(path, "htdemucs_4s", flat)
    x = (np.random.default_rng(5).standard_normal((2, 300)) * 0.5).astype(np.float32)
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None if name == "g++" else which(name))
    kind, tensors = TG.load_ggml(path)
    TAud.write_wav(fresh_build / "a.wav", x, pcm16=True)
    assert native.FALLBACK
    assert kind == "htdemucs_4s" and _same_bits(tensors["a.w"], flat["a.w"])
    JAud.write_wav(fresh_build / "b.wav", x, pcm16=True)
    assert (fresh_build / "a.wav").read_bytes() == (fresh_build / "b.wav").read_bytes()
    assert not (fresh_build / "build").exists()  # nothing was built


def test_failed_build_raises(fresh_build, monkeypatch):
    src = fresh_build / "src"
    src.mkdir()
    (src / "ggml_loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        TG.load_ggml(b"dmc4")
    assert not native.FALLBACK

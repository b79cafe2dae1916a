"""demucs_tpu_torch track orchestration, audio and CLI against demucs_tpu
on the CPU: segment weights, split and overlap-add, the Separator's
normalize/shift/batch bookkeeping, WAV files, and both CLIs on the same
WAV and ggml weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu import audio as JAud
from demucs_tpu import params as JP
from demucs_tpu import pipeline as JPipe
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HTDEMUCS_4S as J4S

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import pipeline as TPipe
from demucs_tpu_torch.cli import main as torch_main

from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("segment,power", [(10, 1.0), (4097, 2.0)])
def test_triangle_weight_identical(segment, power):
    np.testing.assert_array_equal(TPipe.triangle_weight(segment, power),
                                  JPipe.triangle_weight(segment, power))


def test_split_and_overlap_add_identical():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((2, 20011)).astype(np.float32)
    batch, meta = TPipe.split_into_segments(audio, 4096, 3072)
    jbatch, jmeta = JPipe.split_into_segments(audio, 4096, 3072)
    np.testing.assert_array_equal(batch, jbatch)
    assert meta == jmeta
    chunks = np.stack([batch, 2 * batch], axis=1)
    w = TPipe.triangle_weight(4096)
    out = TPipe.overlap_add(chunks, meta, 20011, 4096, w)
    np.testing.assert_array_equal(out, JPipe.overlap_add(chunks, jmeta, 20011, 4096, w))
    np.testing.assert_allclose(out[0], audio, atol=1e-5)


def test_with_segment_matches():
    ours = TPipe.ApplyOptions(batch_size=3).with_segment(16384)
    ref = JPipe.ApplyOptions(batch_size=3).with_segment(16384)
    assert (ours.segment_samples, ours.max_shift_secs, ours.batch_size) == \
        (ref.segment_samples, ref.max_shift_secs, ref.batch_size)


class _Stems(torch.nn.Module):
    """(B, C, L) -> (B, 3, C, L): three nonlinear "sources"."""

    def forward(self, mix):
        return torch.stack([mix, 2.0 * mix, torch.tanh(mix)], dim=1)


def _jax_stems(params, mix):
    return jnp.stack([mix, 2.0 * mix, jnp.tanh(mix)], axis=1)


@pytest.mark.parametrize("offset", [777, None], ids=["pinned", "seeded"])
def test_separator_matches_jax(offset):
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, 30011)) * 0.3 + 0.05).astype(np.float32)
    kw = dict(segment_samples=4096, batch_size=3, shift_offset=offset,
              max_shift_secs=0.02)
    ours = TPipe.Separator(_Stems(), 3, TPipe.ApplyOptions(**kw), device="cpu")(audio)
    ref = JPipe.Separator(_jax_stems, {}, 3, JPipe.ApplyOptions(**kw))(audio)
    assert ours.shape == ref.shape == (3, 2, 30011)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours[0], audio, atol=1e-4)


def test_separator_requires_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        TPipe.Separator(_Stems(), 3)


def test_wav_files_cross_read(tmp_path):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4411)) * 0.4).astype(np.float32)
    for pcm16 in (False, True):
        TAud.write_wav(tmp_path / "port.wav", x, pcm16=pcm16)
        JAud.write_wav(tmp_path / "jax.wav", x, pcm16=pcm16)
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
        ours, rate = TAud.read_wav(tmp_path / "jax.wav")
        ref, _ = JAud.read_wav(tmp_path / "jax.wav", native=False)
        assert rate == 44100
        np.testing.assert_array_equal(ours, ref)
    mono = tmp_path / "mono.wav"
    TAud.write_wav(mono, x[:1])
    np.testing.assert_array_equal(TAud.load_track(mono), JAud.load_track(mono))
    TAud.write_wav(tmp_path / "48k.wav", x, rate=48000)
    with pytest.raises(ValueError, match="44100"):
        TAud.load_track(tmp_path / "48k.wav")


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same WAV and ggml weights (htdemucs-4s at full
    width, 16384-sample segments, pinned shift) write matching stems."""
    flat = JP.init_flat(JP.htdemucs_schema(J4S), seed=0)
    model = tmp_path / "model.bin"
    JP.write_ggml(model, "htdemucs_4s", flat)
    rng = np.random.default_rng(3)
    wav = tmp_path / "in.wav"
    JAud.write_wav(wav, (rng.standard_normal((2, 30000)) * 0.2).astype(np.float32))
    common = ["--offset", "1337", "--batch", "2", "--segment-samples", "16384"]
    assert torch_main([str(model), str(wav), str(tmp_path / "port"),
                       "--device", "cpu"] + common) == 0
    assert jax_main([str(model), str(wav), str(tmp_path / "jax"),
                     "--no-mesh"] + common) == 0
    for i, name in enumerate(J4S.sources):
        stem = f"target_{i}_{name}.wav"
        ours, rate = TAud.read_wav(tmp_path / "port" / stem)
        ref, _ = TAud.read_wav(tmp_path / "jax" / stem)
        assert rate == 44100 and ours.shape == ref.shape == (2, 30000)
        assert np.isfinite(ours).all()
        err = np.abs(ours - ref).max()
        assert err <= 1e-5 * max(np.abs(ref).max(), 1.0), (name, err)


def test_cli_rejects_bad_inputs(tmp_path, monkeypatch, capsys):
    wav = tmp_path / "in.wav"
    TAud.write_wav(wav, np.zeros((2, 100), np.float32))
    with pytest.raises(SystemExit):
        torch_main([str(wav), str(tmp_path)])            # no model
    with pytest.raises(SystemExit):
        torch_main(["m.bin", str(wav), str(tmp_path), "--device", "tpu"])
    assert torch_main([str(tmp_path / "missing.bin"), str(wav), str(tmp_path / "o"),
                       "--device", "cpu"]) == 1
    assert torch_main([str(tmp_path / "m.bin"), str(tmp_path), str(tmp_path / "o"),
                       "--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    JP.write_ggml(tmp_path / "m.bin", "htdemucs_4s", {"x": np.zeros(1)})
    with pytest.raises(RuntimeError, match="no GPU"):
        torch_main([str(tmp_path / "m.bin"), str(wav), str(tmp_path / "o")])

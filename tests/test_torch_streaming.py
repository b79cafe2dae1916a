"""demucs_tpu_torch's streaming separation (`streaming.StreamingSeparator`,
the CLI's `--stream`, alone and with `--ft-dir`) against demucs_tpu's on
the CPU.

The cases of tests/test_streaming.py, ported: with the offline track's
statistics and no shift, the stream equals the offline `Separator`; the
first stems come after one segment; a push's ready segments run in one
device call; running statistics converge. The port's stream is also held
against the JAX `StreamingSeparator` on the same chunking: on the
identity toy to 1e-6, on a narrow htdemucs-4s and on hdemucs_mmi (whose
JAX graph has no narrow form; full width on 8192-sample segments) with
fixed statistics to 1e-5 of max(scale, 1). One difference is by design:
the JAX stream pads each device call to a power-of-two batch (a bound on
XLA's compiled programs), the port runs exactly the ready segments.

Weights come from `init_flat`, inputs from numpy seeds.

    python -m pytest -q tests/test_torch_streaming.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu import audio as JAud
from demucs_tpu import params as JP
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HDEMUCS_V3 as JV3, HTDEMUCS_4S as J4S
from demucs_tpu.models import hdemucs_v3_segment, htdemucs_segment
from demucs_tpu.streaming import StreamingSeparator as JaxStreamingSeparator

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch.cli import main as torch_main
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S
from demucs_tpu_torch.models import build_model
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.pipeline import ApplyOptions, Separator
from demucs_tpu_torch.streaming import StreamingSeparator

from _torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5   # of max(scale, 1)
SEG = 4096
# a narrow htdemucs-4s (tests/test_torch_quant.py)
SMALL = dict(channels=16, bottom_channels=64, t_layers=2)


class _Identity(torch.nn.Module):
    """tests/test_streaming.py's _identity_model: (mix, mix / 2, mix)."""

    def forward(self, mix):
        return torch.stack([mix, mix * 0.5, mix], dim=1)


def _jax_identity(params, mix):
    return jnp.stack([mix, mix * 0.5, mix], axis=1)


class _Counting(_Identity):
    """The identity toy, recording the batch of every call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def forward(self, mix):
        self.calls.append(mix.shape[0])
        return super().forward(mix)


def _stream(sep, audio, steps):
    """Push `audio` in chunks of the given sizes (cycled), then flush;
    the concatenated stems."""
    chunks, pos, k = [], 0, 0
    while pos < audio.shape[-1]:
        step = int(steps[k % len(steps)])
        out = sep.push(audio[:, pos:pos + step])
        if out.shape[-1]:
            chunks.append(out)
        pos, k = pos + step, k + 1
    tail = sep.flush()
    if tail.shape[-1]:
        chunks.append(tail)
    return np.concatenate(chunks, -1)


def _track_stats(audio):
    mono = audio.mean(0)
    return float(mono.mean()), float(mono.std(ddof=1))


def _offline(model, num_sources, audio, seg):
    opts = ApplyOptions(segment_samples=seg, batch_size=4, shift_offset=0, max_shift_secs=0.0)
    return Separator(model, num_sources, opts, "cpu")(audio)


@pytest.mark.parametrize("n", [30011, 20480, 4096])
def test_streaming_matches_offline_and_jax(n):
    """Fixed statistics (the offline track's) and chunks of random sizes:
    the stream equals the offline path to 1e-4 (tests/test_streaming.py's
    bound) and the JAX stream on the same chunking to 1e-6."""
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, n)) * 0.3 + 0.02).astype(np.float32)
    ref = _offline(_Identity(), 3, audio, SEG)
    stats = _track_stats(audio)
    steps = np.random.default_rng(2).integers(100, 7000, size=64)
    got = _stream(StreamingSeparator(_Identity(), 3, segment_samples=SEG, stats=stats,
                                     device="cpu"), audio, steps)
    assert got.shape == ref.shape == (3, 2, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)
    jax_got = _stream(JaxStreamingSeparator(_jax_identity, {}, 3, segment_samples=SEG,
                                            stats=stats), audio, steps)
    np.testing.assert_allclose(got, jax_got, atol=1e-6)


def test_streaming_latency_bound():
    """The first stems come once one segment has arrived: all of the audio
    before the next segment's offset (one stride) is final."""
    stream = StreamingSeparator(_Identity(), 3, segment_samples=SEG, stats=(0.0, 1.0),
                                device="cpu")
    rng = np.random.default_rng(3)
    got = stream.push(rng.standard_normal((2, SEG)).astype(np.float32))
    assert got.shape == (3, 2, 3072)
    got = stream.push(rng.standard_normal((2, 3072)).astype(np.float32))
    assert got.shape == (3, 2, 3072)
    stream.flush()


@pytest.mark.parametrize("max_batch,want", [(8, [6, 1]), (4, [4, 2, 1])])
def test_streaming_batches_ready_segments(max_batch, want):
    """A push spanning several strides runs its ready segments max_batch at
    a time, exactly those segments (no power-of-two padding); the flush
    runs its tail segment the same way."""
    model = _Counting()
    stream = StreamingSeparator(model, 3, segment_samples=SEG, stats=(0.0, 1.0),
                                max_batch=max_batch, device="cpu")
    rng = np.random.default_rng(5)
    # 4096 + 5 * 3072 buffered: 6 ready segments in one push
    stream.push(rng.standard_normal((2, SEG + 3072 * 5)).astype(np.float32))
    stream.flush()
    assert model.calls == want


def test_streaming_running_stats_converge():
    """Without fixed statistics the identity stem is still reconstructed
    (the affine normalization cancels whatever statistics were used)."""
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((2, 30000)) * 0.3).astype(np.float32)
    stream = StreamingSeparator(_Identity(), 3, segment_samples=SEG, stats_seconds=0.05,
                                device="cpu")
    got = _stream(stream, audio, [5000])
    assert got.shape == (3, 2, 30000)
    np.testing.assert_allclose(got[0], audio, atol=1e-3)
    # and the statistics froze at the first chunk, as the JAX stream's
    jax_stream = JaxStreamingSeparator(_jax_identity, {}, 3, segment_samples=SEG,
                                       stats_seconds=0.05)
    np.testing.assert_allclose(got, _stream(jax_stream, audio, [5000]), atol=1e-6)


def test_streaming_run_batch_hook_holds_no_device_state():
    """With a run_batch hook the stream builds no Separator (no device,
    no CUDA stream) and gives the model path's stems; a bf16 model's stems
    come back in f32."""
    audio = np.random.default_rng(6).standard_normal((2, 9000)).astype(np.float32)

    def run_batch(batch):
        return _Identity()(torch.from_numpy(batch)).numpy()

    hooked = StreamingSeparator(None, 3, segment_samples=SEG, stats=(0.0, 1.0),
                                run_batch=run_batch, device="cuda")
    assert hooked.device is None
    direct = StreamingSeparator(_Identity(), 3, segment_samples=SEG, stats=(0.0, 1.0),
                                device="cpu")
    np.testing.assert_array_equal(_stream(hooked, audio, [2000]),
                                  _stream(direct, audio, [2000]))

    class Bf16(_Identity):
        def forward(self, mix):
            return super().forward(mix.bfloat16())

    out = StreamingSeparator(Bf16(), 3, segment_samples=SEG, stats=(0.0, 1.0),
                             device="cpu").push(audio)
    assert out.dtype == np.float32 and out.shape == (3, 2, 6144)


FAMILIES = {
    "htdemucs": (dataclasses.replace(J4S, **SMALL), dataclasses.replace(HTDEMUCS_4S, **SMALL),
                 JP.htdemucs_schema, htdemucs_segment),
    "hdemucs_mmi": (JV3, HDEMUCS_V3, JP.hdemucs_v3_schema, hdemucs_v3_segment),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_streaming_model_matches_jax_and_offline(family):
    """A narrow htdemucs-4s and hdemucs_mmi streamed in 0.1 s chunks on
    8192-sample segments with the track's statistics: within 1e-5 of
    max(scale, 1) of the JAX stream on the same chunking and of the
    offline path without shift. 17000 samples give every device call one
    segment, so the JAX stream compiles one program."""
    jcfg, tcfg, schema, segment = FAMILIES[family]
    flat = {k: np.asarray(v, np.float32)
            for k, v in JP.init_flat(schema(jcfg), seed=0).items()}
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((2, 17000)) * 0.2).astype(np.float32)
    stats = _track_stats(audio)
    model = build_model(tcfg, from_jax_params(flat), "cpu")
    got = _stream(StreamingSeparator(model, 4, segment_samples=8192, stats=stats,
                                     max_batch=2, device="cpu"), audio, [4410])
    assert got.shape == (4, 2, 17000) and np.isfinite(got).all()
    scale = max(float(np.abs(got).max()), 1.0)
    ref = _stream(JaxStreamingSeparator(lambda p, m: segment(p, m, jcfg),
                                        JP.unflatten_tree(flat), 4, segment_samples=8192,
                                        stats=stats, max_batch=2), audio, [4410])
    assert np.abs(got - ref).max() <= TOL * scale
    offline = _offline(model, 4, audio, 8192)
    assert np.abs(got - offline).max() <= TOL * scale


# --- the CLIs --------------------------------------------------------------------

N_TRACK = 17000
STREAM = ["--stream", "--stream-chunk-secs", "0.1", "--batch", "2",
          "--segment-samples", "8192"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four full-width htdemucs-4s files (seeds 0-3) named as the bag's; the
    first also stands alone; and a short track."""
    root = tmp_path_factory.mktemp("stream")
    (root / "ft").mkdir()
    for i, stem in enumerate(J4S.sources):
        JP.write_ggml(root / "ft" / f"htdemucs_ft_{stem}.bin", "htdemucs_4s",
                      JP.init_flat(JP.htdemucs_schema(J4S), seed=i))
    rng = np.random.default_rng(5)
    JAud.write_wav(root / "in.wav", (rng.standard_normal((2, N_TRACK)) * 0.2)
                   .astype(np.float32))
    return root


def _stems(outdir):
    out = []
    for i, name in enumerate(J4S.sources):
        stem, rate = TAud.read_wav(outdir / f"target_{i}_{name}.wav")
        assert rate == 44100 and stem.shape == (2, N_TRACK) and np.isfinite(stem).all()
        out.append(stem)
    return np.stack(out)


@pytest.mark.parametrize("bag", [False, True], ids=["model", "ft_dir"])
def test_stream_cli_matches_jax_cli(files, tmp_path, bag, capsys):
    """Both CLIs with --stream, one full-width htdemucs-4s or the bag of
    four (--ft-dir): the same stems within 1e-5 of max(scale, 1), and the
    realtime factor on stderr."""
    model = (["--ft-dir", str(files / "ft")] if bag
             else [str(files / "ft" / "htdemucs_ft_drums.bin")])
    args = model + [str(files / "in.wav")]
    assert torch_main(args + [str(tmp_path / "port"), "--device", "cpu"] + STREAM) == 0
    assert "x realtime" in capsys.readouterr().err
    assert jax_main(args + [str(tmp_path / "jax"), "--no-mesh"] + STREAM) == 0
    ours, ref = _stems(tmp_path / "port"), _stems(tmp_path / "jax")
    assert np.abs(ours - ref).max() <= TOL * max(float(np.abs(ref).max()), 1.0)


def test_stream_cli_follows_the_jax_cli_flags(files, tmp_path, capsys):
    """--stream refuses --fused and --transfer-int16 and a directory, as
    the JAX CLI does, and reads neither --int8 nor --fp8: its stems equal
    the dense stream's bit for bit."""
    model = str(files / "ft" / "htdemucs_ft_drums.bin")
    wav = str(files / "in.wav")
    for flag in ("--fused", "--transfer-int16"):
        with pytest.raises(SystemExit):
            torch_main([model, wav, str(tmp_path / "x"), "--device", "cpu", flag] + STREAM)
        assert "--stream has its own device path" in capsys.readouterr().err
    assert torch_main([model, str(files), str(tmp_path / "x"), "--device", "cpu"]
                      + STREAM) == 1
    assert "single WAV" in capsys.readouterr().err
    assert torch_main([model, wav, str(tmp_path / "dense"), "--device", "cpu"] + STREAM) == 0
    assert torch_main([model, wav, str(tmp_path / "int8"), "--device", "cpu", "--int8"]
                      + STREAM) == 0
    np.testing.assert_array_equal(_stems(tmp_path / "int8"), _stems(tmp_path / "dense"))

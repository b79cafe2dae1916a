"""demucs_tpu_torch's Demucs v3 (hdemucs_mmi) against demucs_tpu on the CPU:
the BiLSTM recurrence's plain twin (K6's reference) against the Pallas
kernel in interpret mode and the lax.scan, the 2-layer BiLSTM, LocalState,
the schema, the module's names, ggml files both ways, the whole segment
graph at full width, and both CLIs on the same WAV and weights.

Inputs come from numpy seeds and weights from `demucs_tpu.params.init_flat`,
carried over by `from_jax_params`. Everything runs in f32; the graphs
differ only in the order of sums, so the model is held to 1e-5 of its
output's scale, as tests/test_torch_model.py holds v4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import audio as JAud
from demucs_tpu import ops as JO
from demucs_tpu import params as JP
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HDEMUCS_V3 as JV3
from demucs_tpu.models import hdemucs_v3_segment
from demucs_tpu.ops.lstm import _scan_recurrence
from demucs_tpu.ops.pallas.lstm import bilstm_recurrence as pallas_bilstm_recurrence

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import ops as TO
from demucs_tpu_torch import params as TP
from demucs_tpu_torch.cli import main as torch_main
from demucs_tpu_torch.config import HDEMUCS_V3
from demucs_tpu_torch.models import HDemucsV3, build_hdemucs_v3, build_model
from demucs_tpu_torch.models.hdemucs_v3 import LocalState
from demucs_tpu_torch.ops.cuda import bilstm_recurrence, bilstm_recurrence_plain
from demucs_tpu_torch.tools import train_cli

SEG = 1024 * 32
TOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- K6's plain twin and the BiLSTM -----------------------------------------

def test_recurrence_plain_matches_pallas_and_scan():
    """The plain twin against the Pallas kernel (interpret mode) and the
    JAX package's lax.scan, at the shape and tolerance of
    tests/test_pallas.py::test_pallas_bilstm_matches_scan."""
    T, B, H = 37, 2, 16
    xs, w_hh = _rand(T, 2, B, 4 * H, seed=1), _rand(2, H, 4 * H, seed=2, scale=0.2)
    ours = bilstm_recurrence_plain(_t(xs), _t(w_hh)).numpy()
    assert ours.shape == (T, 2, B, H)
    pallas = pallas_bilstm_recurrence(jnp.asarray(xs), jnp.asarray(w_hh), interpret=True)
    np.testing.assert_allclose(ours, np.asarray(pallas), atol=2e-6)
    np.testing.assert_allclose(ours, np.asarray(_scan_recurrence(jnp.asarray(xs),
                                                                 jnp.asarray(w_hh))),
                               atol=2e-6)


def test_recurrence_wrapper_on_cpu_tensors():
    """For CPU tensors the wrapper is the plain twin and launches nothing;
    a device that is neither CPU nor CUDA is refused."""
    xs, w_hh = _t(_rand(5, 2, 3, 32, seed=3)), _t(_rand(2, 8, 32, seed=4, scale=0.3))
    before = bilstm_recurrence.launches
    out = bilstm_recurrence(xs, w_hh)
    assert bilstm_recurrence.launches == before
    assert torch.equal(out, bilstm_recurrence_plain(xs, w_hh))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bilstm_recurrence(xs.to("meta"), w_hh.to("meta"))


def _lstm_layers(C, H, seed):
    """Two bidirectional layers of random weights, as numpy dicts in
    ops.bilstm's structure (layer 2 takes the 2H concatenation)."""
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(2):
        cin = C if i == 0 else 2 * H
        layers.append({d: {"weight_ih": rng.standard_normal((4 * H, cin)) * 0.2,
                           "weight_hh": rng.standard_normal((4 * H, H)) * 0.2,
                           "bias_ih": rng.standard_normal(4 * H) * 0.1,
                           "bias_hh": rng.standard_normal(4 * H) * 0.1}
                       for d in ("forward", "reverse")})
    return [{d: {k: v.astype(np.float32) for k, v in p.items()} for d, p in layer.items()}
            for layer in layers]


def test_bilstm_matches_jax():
    B, T, C, H = 2, 37, 24, 16
    layers = _lstm_layers(C, H, seed=5)
    x = _rand(B, T, C, seed=6)
    ours = TO.bilstm(_t(x), [{d: {k: _t(v) for k, v in p.items()} for d, p in layer.items()}
                             for layer in layers])
    ref = np.asarray(JO.bilstm(jnp.asarray(x), jax.tree.map(jnp.asarray, layers)))
    assert ours.shape == ref.shape == (B, T, 2 * H)
    assert np.abs(ours.numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_bilstm_matches_torch_lstm():
    """The same weights in torch.nn.LSTM (an independent implementation of
    the gate maths and the direction flip)."""
    B, T, C, H = 2, 23, 12, 8
    layers = _lstm_layers(C, H, seed=7)
    lstm = torch.nn.LSTM(C, H, 2, bidirectional=True, batch_first=True)
    with torch.no_grad():
        for i, layer in enumerate(layers):
            for d, suffix in (("forward", ""), ("reverse", "_reverse")):
                for k, v in layer[d].items():
                    getattr(lstm, f"{k}_l{i}{suffix}").copy_(_t(v))
    x = _t(_rand(B, T, C, seed=8))
    with torch.no_grad():
        ref, _ = lstm(x)
        ours = TO.bilstm(x, [{d: {k: _t(v) for k, v in p.items()} for d, p in layer.items()}
                             for layer in layers])
    torch.testing.assert_close(ours, ref, rtol=0, atol=2e-6)


# --- LocalState ---------------------------------------------------------------

def test_decay_kernel_identical():
    np.testing.assert_array_equal(TO.decay_kernel(50), JO.decay_kernel(50))


def test_local_attention_matches_jax():
    B, C, T = 2, 32, 50
    with torch.device("meta"):
        state = LocalState(C, 4, 4)
    flat = {name: _rand(*p.shape, seed=10 + i, scale=0.3 if name.endswith("weight") else 0.05)
            for i, (name, p) in enumerate(state.state_dict().items())}
    state.load_state_dict({k: _t(v) for k, v in flat.items()}, assign=True)
    x = _rand(B, C, T, seed=9)
    with torch.no_grad():
        ours = TO.local_attention(_t(x), state)
    ref = np.asarray(JO.local_attention(jnp.asarray(x), JP.unflatten_tree(flat)))
    assert ours.shape == ref.shape == (B, C, T)
    assert np.abs(ours.numpy() - ref).max() <= TOL * np.abs(ref).max()


# --- weights ------------------------------------------------------------------

def test_v3_schema_equals_jax():
    ours = TP.hdemucs_v3_schema(HDEMUCS_V3)
    assert list(ours.items()) == list(JP.hdemucs_v3_schema(JV3).items())


def test_v3_module_parameter_names_are_the_schema():
    with torch.device("meta"):
        model = HDemucsV3(HDEMUCS_V3)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == TP.hdemucs_v3_schema(HDEMUCS_V3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v3_ggml_both_ways(tmp_path, writer):
    """A dmc3 file written by one package and read by the other."""
    flat = JP.init_flat(JP.hdemucs_v3_schema(JV3), seed=1)
    path = tmp_path / "v3.bin"
    if writer == "jax":
        JP.write_ggml(path, "hdemucs_mmi", flat)
        cfg, sd = TP.load_model_params(path)
        assert cfg == HDEMUCS_V3
        ref = JP.flatten_tree(JP.load_model_params(path)[1])
        assert set(sd) == set(ref)
        for name, arr in ref.items():
            assert tuple(sd[name].shape) == arr.shape
            np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)
    else:
        TP.write_ggml(path, "hdemucs_mmi", TP.from_jax_params(flat))
        kind, tensors = JP.load_ggml(path)
        assert kind == "hdemucs_mmi" and list(tensors) == list(flat)
        for name, arr in flat.items():
            want = np.squeeze(arr.astype(np.float32)).astype(np.float16)
            np.testing.assert_array_equal(tensors[name], want, err_msg=name)


# --- the segment graph and the CLI ----------------------------------------

def _compare(length, batch=1, seed=0):
    flat = JP.init_flat(JP.hdemucs_v3_schema(JV3), seed=seed)
    model = build_hdemucs_v3(HDEMUCS_V3, TP.from_jax_params(flat), "cpu")
    rng = np.random.default_rng(42 + seed)
    mix = (rng.standard_normal((batch, 2, length)) * 0.1).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(mix)).numpy()
    ref = np.asarray(jax.jit(lambda p, m: hdemucs_v3_segment(p, m, JV3))(
        JP.unflatten_tree(flat), jnp.asarray(mix)))
    assert ours.shape == ref.shape == (batch, 4, 2, length)
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max()
    scale = np.abs(ref).max()
    assert diff < TOL * max(scale, 1.0), (diff, scale)


@pytest.mark.parametrize("length,batch", [(SEG, 1), (SEG - 1000, 2)], ids=["b1", "b2-ragged"])
def test_hdemucs_v3_matches_jax(length, batch):
    """Batch 2 at a length that is not a multiple of the STFT hop reaches
    the time encoders' stride padding and the spectrogram's right pad."""
    _compare(length, batch, seed=batch - 1)


@pytest.mark.slow
def test_hdemucs_v3_matches_jax_full_segment():
    """The full 7.8 s segment: the only length that reaches the BiLSTM's
    T=336 (encoder 4) and T=168 (encoder 5)."""
    _compare(343980)


def test_build_model_picks_the_family():
    schema = TP.hdemucs_v3_schema(HDEMUCS_V3)
    sd = TP.from_state_dict(TP.init_flat(schema), schema)
    assert isinstance(build_model(HDEMUCS_V3, sd), HDemucsV3)
    sd.pop("encoder.4.dconv.layers.1.3.lstm.weight_hh_l1_reverse")
    with pytest.raises(RuntimeError, match="weight_hh_l1_reverse"):
        build_hdemucs_v3(HDEMUCS_V3, sd)


def test_v3_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same WAV and dmc3 weights (full width, 16384-sample
    segments, pinned shift) write matching stems."""
    model = tmp_path / "v3.bin"
    JP.write_ggml(model, "hdemucs_mmi", JP.init_flat(JP.hdemucs_v3_schema(JV3), seed=0))
    wav = tmp_path / "in.wav"
    JAud.write_wav(wav, _rand(2, 30000, seed=3, scale=0.2))
    common = ["--offset", "1337", "--batch", "2", "--segment-samples", "16384"]
    assert torch_main([str(model), str(wav), str(tmp_path / "port"),
                       "--device", "cpu"] + common) == 0
    assert jax_main([str(model), str(wav), str(tmp_path / "jax"), "--no-mesh"] + common) == 0
    for i, name in enumerate(JV3.sources):
        stem = f"target_{i}_{name}.wav"
        ours, rate = TAud.read_wav(tmp_path / "port" / stem)
        ref, _ = TAud.read_wav(tmp_path / "jax" / stem)
        assert rate == 44100 and ours.shape == ref.shape == (2, 30000)
        assert np.isfinite(ours).all()
        err = np.abs(ours - ref).max()
        assert err <= TOL * max(np.abs(ref).max(), 1.0), (name, err)


def test_train_cli_refuses_a_v3_checkpoint(tmp_path):
    """v3 training is not ported: --init-from a dmc3 file stops with a
    usage error, not inside the v4 model."""
    path = tmp_path / "v3.bin"
    JP.write_ggml(path, "hdemucs_mmi", JP.init_flat(JP.hdemucs_v3_schema(JV3)))
    with pytest.raises(SystemExit):
        train_cli.main(["--synthetic", "--init-from", str(path), "--device", "cpu"])

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
from demucs_tpu.params.ggml import load_model_params as jax_load_model_params
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
from demucs_tpu_torch.models.hdemucs_v3 import BLSTM, LocalState
from demucs_tpu_torch.ops.cuda import bilstm_recurrence, bilstm_recurrence_plain
from demucs_tpu_torch.tools import train_cli

from _torch_threads import _one_torch_thread  # noqa: F401

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


def test_blstm_packs_once_and_follows_new_weights():
    """BLSTM.packed() packs on the first call and hands back the same pack
    while the weights stay; an in-place change of one weight, a strict
    load_state_dict (in place, or by assignment) and .to() each make it
    pack anew, so the BiLSTM always runs on the current weights."""
    blstm = BLSTM(16)
    x = _t(_rand(2, 11, 16, seed=9))
    sd = {k: _t(_rand(*v.shape, seed=10 + i, scale=0.2))
          for i, (k, v) in enumerate(blstm.state_dict().items())}

    def run():
        return TO.bilstm_packed(x, blstm.packed())

    with torch.inference_mode():
        first = blstm.packed()
        assert blstm.packed() is first
        out_a = run()
    blstm.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        out_b = run()
        assert blstm.packed() is not first
        assert torch.equal(out_b, TO.bilstm(x, blstm.layers()))
        assert not torch.allclose(out_a, out_b)
    with torch.no_grad():
        blstm.lstm.weight_hh_l1_reverse.mul_(0.5)
        assert torch.equal(run(), TO.bilstm(x, blstm.layers()))
    blstm.load_state_dict({k: v * 0.5 for k, v in sd.items()}, strict=True, assign=True)
    with torch.no_grad():
        assert torch.equal(run(), TO.bilstm(x, blstm.layers()))
        blstm.to(torch.float64)
        assert blstm.packed()[0][2].dtype == torch.float64


def test_hdemucs_v3_follows_a_load_after_its_first_call():
    """The whole model: called once on one set of weights (which packs
    every BiLSTM), then strictly loaded with another, it gives exactly the
    output of a model built on the second set, not the first's."""
    schema = TP.hdemucs_v3_schema(HDEMUCS_V3)
    sd_a, sd_b = (TP.from_state_dict(TP.init_flat(schema, seed=s), schema) for s in (3, 4))
    mix = torch.from_numpy(_rand(1, 2, SEG // 2, seed=11, scale=0.1))
    model = build_hdemucs_v3(HDEMUCS_V3, sd_a, "cpu")
    with torch.inference_mode():
        out_a = model(mix)
    model.load_state_dict(sd_b, strict=True)
    with torch.inference_mode():
        out_b = model(mix)
        want = build_hdemucs_v3(HDEMUCS_V3, sd_b, "cpu")(mix)
    assert torch.equal(out_b, want)
    assert not torch.allclose(out_a, out_b)


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
    assert isinstance(build_model(HDEMUCS_V3, sd, "cpu"), HDemucsV3)
    sd.pop("encoder.4.dconv.layers.1.3.lstm.weight_hh_l1_reverse")
    with pytest.raises(RuntimeError, match="weight_hh_l1_reverse"):
        build_hdemucs_v3(HDEMUCS_V3, sd, "cpu")


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


def test_train_cli_trains_from_a_v3_checkpoint(tmp_path, capsys):
    """--init-from a dmc3 file the JAX package wrote: the family is taken
    from it (a conflicting --family is refused), 2 steps at full width
    with EMA, and --export-ggml writes it as hdemucs_mmi; the exported file
    loads in demucs_tpu as v3 and holds the EMA weights (to the
    container's fp16)."""
    flat = JP.init_flat(JP.hdemucs_v3_schema(JV3))
    base, out, ck = tmp_path / "v3.bin", tmp_path / "trained.bin", tmp_path / "ck"
    JP.write_ggml(base, "hdemucs_mmi", flat)
    common = ["--synthetic", "--init-from", str(base), "--device", "cpu", "--batch", "1",
              "--segment-samples", "8192"]
    assert train_cli.main(common + ["--steps", "2", "--ema", "0.9", "--ckpt", str(ck),
                                    "--export-ggml", str(out)]) == 0
    err = capsys.readouterr().err
    assert "initialized from" in err and "(hdemucs_v3)" in err
    assert "step 2/2" in err and "exported EMA weights" in err and "(hdemucs_mmi)" in err
    cfg, tree = jax_load_model_params(out)
    assert type(cfg).__name__ == "HDemucsV3Config"
    exported = JP.flatten_tree(tree)
    state = torch.load(ck, weights_only=True)
    assert set(exported) == set(state["ema"])
    for name, e in state["ema"].items():
        np.testing.assert_array_equal(
            np.asarray(exported[name]).reshape(e.shape),
            e.numpy().astype(np.float16).astype(np.float32), err_msg=name)
    name = "encoder.4.dconv.layers.0.3.lstm.weight_hh_l0"
    assert 0 < np.abs(state["params"][name].numpy() - flat[name]).max() < 0.05
    with pytest.raises(SystemExit):
        train_cli.main(common + ["--family", "htdemucs_4s", "--steps", "1"])
    for f in (base, out, ck):  # 1.9 GB in all: pytest keeps its last temp dirs
        f.unlink()

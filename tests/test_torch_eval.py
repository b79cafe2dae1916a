"""Evaluation and checkpoint directories in demucs_tpu_torch, against
demucs_tpu on the CPU: the port's copy of `tools/evaluate_sdr.py`
(SDR and BSS-eval v4 on synthetic signals, and the REF_DIR EST_DIR CLI),
`params/checkpoint_io.py` (round trip, `infer_kind`, a directory as a
model for `load_model_params`, the inference CLI and `--init-from`), and
the training CLI's evaluation loop (`--eval-every`, `--eval-data`,
`--eval-sdr`: `CKPT.eval.jsonl`, `CKPT.best`).

The SDR functions are numpy in both packages and the port's is a copy:
they are held to each other to 1e-9 relative (their float64 sums in the
same order agree bit for bit in practice).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from demucs_tpu import params as JP
from demucs_tpu.config import HDEMUCS_V3 as JV3
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.config import HTDEMUCS_6S as J6S
from demucs_tpu.params.orbax_io import infer_kind as jax_infer_kind
from demucs_tpu.tools import evaluate_sdr as JE

from demucs_tpu_torch import audio
from demucs_tpu_torch.cli import main as cli_main
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.params import (from_jax_params, infer_kind, load_checkpoint,
                                     load_model_params, save_checkpoint)
from demucs_tpu_torch.params.checkpoint_io import load_flat
from demucs_tpu_torch.tools import evaluate_sdr as TE
from demucs_tpu_torch.tools.train_cli import main as train_main

from _torch_threads import _one_torch_thread  # noqa: F401

SR = 44100
RTOL = 1e-9
SEG = 8192


def _signals(seed, J=2, C=2, n=int(2.5 * SR)):
    """References and estimates: the references plus noise and a little
    crosstalk, one silent second in source 0's reference."""
    rng = np.random.default_rng(seed)
    refs = (rng.standard_normal((J, C, n)) * 0.1).astype(np.float32)
    refs[0, :, SR:2 * SR] = 0.0
    ests = refs + 0.02 * rng.standard_normal(refs.shape).astype(np.float32)
    ests[1] += 0.1 * refs[0]
    return refs, ests


@pytest.mark.parametrize("seed", [0, 1])
def test_sdr_functions_match_jax(seed):
    refs, ests = _signals(seed)
    for j in range(refs.shape[0]):
        ours = TE.sdr_framewise(refs[j], ests[j])
        np.testing.assert_allclose(ours, JE.sdr_framewise(refs[j], ests[j]), rtol=RTOL)
        assert ours.size == (1 if j == 0 else 2)  # the silent window is skipped
        np.testing.assert_allclose(TE.median_sdr(refs[j], ests[j]),
                                   JE.median_sdr(refs[j], ests[j]), rtol=RTOL)
    assert np.isnan(TE.median_sdr(refs[0][:, :SR // 2], ests[0][:, :SR // 2]))


def test_bss_eval_matches_jax():
    refs, ests = _signals(2, n=2 * SR)
    ours = TE.bss_eval_framewise(refs, ests, filters_len=8)
    ref = JE.bss_eval_framewise(refs, ests, filters_len=8)
    for k in ("SDR", "ISR", "SIR", "SAR"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, equal_nan=True, err_msg=k)
    med = TE.median_bss_eval(refs, ests, filters_len=8)
    assert med == JE.median_bss_eval(refs, ests, filters_len=8)
    # v4 SDR is filter-free: it equals the plain energy ratio
    np.testing.assert_allclose(ours["SDR"][1], TE.sdr_framewise(refs[1], ests[1]), rtol=1e-9)


def test_evaluate_sdr_cli_matches_jax(tmp_path, capsys):
    refs, ests = _signals(3, J=4)
    for d, x in (("ref", refs), ("est", ests)):
        for i, stem in enumerate(HTDEMUCS_4S.sources):
            (tmp_path / d).mkdir(exist_ok=True)
            name = f"{stem}.wav" if d == "ref" else f"target_{i}_{stem}.wav"
            audio.write_wav(tmp_path / d / name, x[i])
    args = [str(tmp_path / "ref"), str(tmp_path / "est"), "--sdr-only"]
    assert TE.main(args) == 0
    ours = json.loads(capsys.readouterr().out)
    assert JE.main(args) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert set(ours) == set(HTDEMUCS_4S.sources)
    assert TE.main(args[:2] + ["--filter-len", "4", "--stems", "bass"]) == 0
    full = json.loads(capsys.readouterr().out)
    assert set(full["bass"]) == {"SDR", "ISR", "SIR", "SAR"}


# --- checkpoint directories ---------------------------------------------------------

@pytest.mark.parametrize("jcfg,schema,kind", [
    (J4S, JP.htdemucs_schema, "htdemucs_4s"), (J6S, JP.htdemucs_schema, "htdemucs_6s"),
    (JV3, JP.hdemucs_v3_schema, "hdemucs_v3")], ids=["4s", "6s", "v3"])
def test_checkpoint_round_trip_and_kind(tmp_path, jcfg, schema, kind):
    """save_checkpoint -> load_flat bit for bit (dtypes kept, bf16 too),
    infer_kind as the JAX package's, and load_model_params of the
    directory: the family's config and the weights in f32."""
    flat = JP.init_flat(schema(jcfg), seed=1)
    sd = from_jax_params(flat)
    save_checkpoint(tmp_path / "ck", sd)
    back = load_flat(tmp_path / "ck")
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert infer_kind(back) == jax_infer_kind(flat) == kind
    cfg, loaded = load_model_params(tmp_path / "ck")
    assert type(cfg).__name__ == type(jcfg).__name__ and cfg.num_sources == jcfg.num_sources
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    half = load_checkpoint(tmp_path / "ck", torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())
    save_checkpoint(tmp_path / "bf16", half)
    assert all(torch.equal(v, half[k]) for k, v in load_flat(tmp_path / "bf16").items())
    for d in ("ck", "bf16"):  # full width: pytest keeps its last temp dirs
        shutil.rmtree(tmp_path / d)


def test_checkpoint_io_refuses_what_it_cannot_read(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        load_model_params(tmp_path / "orbax")
    flat = JP.init_flat(JP.htdemucs_schema(J4S), seed=1)
    with pytest.raises(ValueError, match="output channels"):
        infer_kind({**flat, "decoder.3.conv_tr.weight": np.zeros((48, 12, 8, 1))})
    flat.pop("decoder.3.conv_tr.weight")
    with pytest.raises(ValueError, match="crosstransformer"):
        infer_kind(flat)


def test_checkpoint_directory_as_a_model(tmp_path, capsys):
    """A full-width htdemucs-4s checkpoint directory separates through the
    inference CLI as its ggml file does (bit for bit: the ggml file holds
    the same fp16-exact weights), and starts a training run."""
    flat = {k: v.astype(np.float16).astype(np.float32)
            for k, v in JP.init_flat(JP.htdemucs_schema(J4S), seed=2).items()}
    save_checkpoint(tmp_path / "ck", from_jax_params(flat))
    JP.write_ggml(tmp_path / "m.bin", "htdemucs_4s", flat)
    track = (np.random.default_rng(4).standard_normal((2, 20000)) * 0.1).astype(np.float32)
    audio.write_wav(tmp_path / "in.wav", track)
    for model, out in ((tmp_path / "ck", "a"), (tmp_path / "m.bin", "b")):
        assert cli_main([str(model), str(tmp_path / "in.wav"), str(tmp_path / out),
                         "--device", "cpu", "--batch", "1", "--segment-samples", str(SEG)]) == 0
    for i, stem in enumerate(HTDEMUCS_4S.sources):
        a, _ = audio.read_wav(tmp_path / "a" / f"target_{i}_{stem}.wav")
        b, _ = audio.read_wav(tmp_path / "b" / f"target_{i}_{stem}.wav")
        assert a.shape == track.shape and np.array_equal(a, b), stem
    assert train_main(["--synthetic", "--device", "cpu", "--batch", "1", "--segment-samples",
                       str(SEG), "--steps", "1", "--init-from", str(tmp_path / "ck")]) == 0
    assert "(htdemucs_4s)" in capsys.readouterr().err
    shutil.rmtree(tmp_path / "ck")  # full width: pytest keeps its last temp dirs
    (tmp_path / "m.bin").unlink()


# --- the evaluation loop ------------------------------------------------------------

def _cli(*args):
    return train_main(["--test-tiny", "--device", "cpu", "--batch", "1",
                       "--segment-samples", str(SEG), "--log-every", "1", *args])


def _records(ck):
    return [json.loads(line) for line in open(str(ck) + ".eval.jsonl")]


def test_train_cli_eval_on_synthetic(tmp_path, capsys):
    """--eval-every 2 over 5 steps: evals at 2, 4 and the closing one at 5,
    on the EMA weights, each an L1 and a per-stem SDR record; a best
    checkpoint at the best step holds that step's state."""
    ck = tmp_path / "ck"
    assert _cli("--synthetic", "--steps", "5", "--ema", "0.5", "--ckpt", str(ck),
                "--eval-every", "2", "--eval-sdr") == 0
    err = capsys.readouterr().err
    assert "eval set: 1 held-out track(s)" in err and "eval @ step 5" in err
    recs = _records(ck)
    assert [r["step"] for r in recs] == [2, 4, 5]
    assert all(r["weights"] == "ema" and np.isfinite(r["l1"]) for r in recs)
    assert all(set(r["sdr"]) == set(HTDEMUCS_4S.sources) for r in recs)
    best = [r for r in recs if r.get("best")]
    assert best[0]["step"] == 2 and all(b["l1"] < a["l1"] for a, b in zip(best, best[1:]))
    assert torch.load(str(ck) + ".best", weights_only=True)["step"] == best[-1]["step"]
    assert f"best eval l1 {best[-1]['l1']:.5f} at step {best[-1]['step']}" in err


def test_train_cli_eval_on_held_out_dirs(tmp_path, capsys):
    """--eval-data over MUSDB-layout dirs: the current weights (no --ema)
    scored each eval; with tracks longer than a 1 s SDR window the SDRs
    are finite."""
    rng = np.random.default_rng(5)
    for split, n in (("train", 2), ("valid", 2)):
        for t in range(n):
            d = tmp_path / split / f"track{t}"
            d.mkdir(parents=True)
            for stem in HTDEMUCS_4S.sources:
                audio.write_wav(d / f"{stem}.wav",
                                (rng.standard_normal((2, SR + 5000)) * 0.1).astype(np.float32))
    ck = tmp_path / "ck"
    assert _cli("--data", str(tmp_path / "train"), "--eval-data", str(tmp_path / "valid"),
                "--steps", "2", "--eval-every", "1", "--eval-sdr", "--ckpt", str(ck)) == 0
    assert "eval set: 2 held-out track(s)" in capsys.readouterr().err
    recs = _records(ck)
    assert [r["step"] for r in recs] == [1, 2]
    assert all(r["weights"] == "params" for r in recs)
    assert all(np.isfinite(list(r["sdr"].values())).all() for r in recs)

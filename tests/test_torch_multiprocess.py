"""The port's command lines over several processes, against themselves
in one process, on the CPU (gloo).

  * the inference CLI's `run_ranks` (the spawn of one rank per card,
    here 2 gloo ranks on the CPU) writes the stems of the single-process
    CLI, full-width htdemucs-4s on 16384-sample segments, at dp=2 and at
    --tp 2 (atol 2e-5, as tests/test_parallel.py holds the JAX mesh to
    the single device); a failing rank makes it return 1;
  * the training CLI with --coordinator/--num-processes 2/--process-id
    (the tiny htdemucs of --test-tiny, 2 steps, --ema, --ckpt,
    --export-ggml, --eval-every) against the same command in one
    process, and `--resume` of each checkpoint to a third step, the
    2-process one at --tp 2 (each rank its slice of the saved state), at
    tests/test_multiprocess.py's tolerance (rtol 1e-2, atol 1e-3: Adam's
    update is about lr x sign(g) whatever |g|, so the order of the dp sum
    shows on gradients that are rounding residues);
  * the argument errors, and both CLIs' flags against the JAX CLIs'.
"""

import argparse
import shutil

import numpy as np
import pytest
import torch

from demucs_tpu import cli as j_cli
from demucs_tpu.tools import train_cli as j_train_cli

from demucs_tpu_torch import audio
from demucs_tpu_torch import cli
from demucs_tpu_torch import params as P
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.params.ggml import load_ggml
from demucs_tpu_torch.tools import train_cli

from _torch_ranks import REPO, run_ranks
from _torch_threads import _one_torch_thread  # noqa: F401

WORKER = REPO / "tests" / "torch_cli_worker.py"
SEG = "16384"
TRAIN = ["--synthetic", "--steps", "2", "--batch", "4", "--segment-samples", "8192",
         "--log-every", "1", "--test-tiny", "--seed", "0", "--lr", "1e-3", "--ema", "0.9",
         "--save-every", "100", "--device", "cpu"]
RTOL, ATOL = 1e-2, 1e-3


@pytest.fixture(scope="module")
def track_and_model(tmp_path_factory):
    """A full-width htdemucs-4s ggml file (seed 7) and a 1.6 s stereo WAV
    (two 16384-sample segments); deleted after the module."""
    where = tmp_path_factory.mktemp("cli")
    model = where / "htdemucs_4s.bin"
    P.write_ggml(model, "htdemucs_4s", P.init_flat(P.htdemucs_schema(HTDEMUCS_4S), seed=7))
    wav = where / "mix.wav"
    rng = np.random.default_rng(21)
    audio.write_wav(wav, (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32))
    yield where, model, wav
    shutil.rmtree(where, ignore_errors=True)


@pytest.fixture
def workdir(tmp_path):
    """tmp_path, deleted after the test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _stems(d):
    return np.stack([audio.load_track(d / f"target_{i}_{name}.wav")
                     for i, name in enumerate(HTDEMUCS_4S.sources)])


def test_cli_ranks_write_the_single_process_stems(track_and_model):
    where, model, wav = track_and_model
    common = [str(model), str(wav)]
    flags = ["--device", "cpu", "--segment-samples", SEG, "--batch", "2"]
    assert cli.main(common + [str(where / "one")] + flags) == 0
    want = _stems(where / "one")
    for name, extra in (("dp", []), ("tp", ["--tp", "2"])):
        logs = run_ranks(WORKER, 1, "spawn", "2", *common, str(where / name), *flags, *extra)
        got = _stems(where / name)
        assert got.shape == want.shape == (4, 2, 24000)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=name)
        assert "ranks" in logs[0] and logs[0].count("wrote ") == 4  # rank 0 alone writes


def test_cli_rank_failure_fails_the_command(track_and_model):
    where, _, wav = track_and_model
    run_ranks(WORKER, 1, "spawn", "2", str(where / "missing.bin"), str(wav),
              str(where / "none"), "--device", "cpu", expect=1)
    assert not (where / "none").exists()


def _state(path):
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["step"], state["params"], state["ema"]


def _close(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def test_training_cli_over_two_processes(workdir):
    """2 processes (dp=2) against 1, then --resume to step 3 (the 2-process
    run at --tp 2, dp=1: each rank its slice of the dp=2 checkpoint)."""
    one, two = workdir / "one", workdir / "two"
    for d in (one, two):
        d.mkdir()
    extra = lambda d: ["--ckpt", str(d / "ck"), "--export-ggml", str(d / "out.bin"),  # noqa: E731
                       "--eval-every", "2"]
    assert train_cli.main(TRAIN + extra(one)) == 0
    logs = run_ranks(WORKER, 2, "train", *TRAIN, *extra(two))
    assert "step 2/2" in logs[0] and "step 2/2" not in logs[1]  # only rank 0 logs
    s1, p1, e1 = _state(one / "ck")
    s2, p2, e2 = _state(two / "ck")
    assert s1 == s2 == 2
    _close(p2, p1, "params")
    _close(e2, e1, "ema")
    exported = [{k: torch.from_numpy(np.array(v)) for k, v in load_ggml(d / "out.bin")[1].items()}
                for d in (one, two)]
    _close(exported[1], exported[0], "exported EMA")
    assert (two / "ck.best").exists() and len((two / "ck.eval.jsonl").read_text().splitlines()) == 1

    resume = [a if a != "2" or i != 2 else "3" for i, a in enumerate(TRAIN)] + ["--resume"]
    assert resume[1:3] == ["--steps", "3"]
    assert train_cli.main(resume + ["--ckpt", str(one / "ck")]) == 0
    run_ranks(WORKER, 2, "train", *resume, "--ckpt", str(two / "ck"), "--tp", "2")
    s1, p1, e1 = _state(one / "ck")
    s2, p2, e2 = _state(two / "ck")
    assert s1 == s2 == 3
    _close(p2, p1, "resumed params")
    _close(e2, e1, "resumed ema")


def test_training_cli_refuses_a_batch_that_dp_does_not_divide():
    args = [a if a != "4" else "3" for a in TRAIN]
    logs = run_ranks(WORKER, 2, "train", *args, expect=2)
    assert "must divide by dp=2" in logs[0]


@pytest.mark.parametrize("argv,msg", [
    (["--num-processes", "2"], "needs --coordinator"),
    (["--num-processes", "2", "--coordinator", "127.0.0.1:1", "--steps-per-call", "2",
      "--save-every", "2"], "single-process only"),
    (["--num-processes", "2", "--coordinator", "127.0.0.1:1", "--process-id", "2"],
     "--process-id"),
    (["--tp", "0"], "--tp"),
])
def test_training_cli_argument_errors(capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--synthetic", "--device", "cpu"] + argv)
    assert e.value.code == 2 and msg in capsys.readouterr().err


def test_cli_tp_must_be_positive(capsys):
    with pytest.raises(SystemExit):
        cli.main(["m.bin", "in.wav", "out", "--tp", "0"])
    assert "--tp" in capsys.readouterr().err


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch) -> set:
    def stop(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as caught:
            main([])
    return {a.option_strings[0] for a in caught.value.args[0]._actions if a.option_strings}


@pytest.mark.parametrize("jax_main,port_main", [(j_cli.main, cli.main),
                                                (j_train_cli.main, train_cli.main)],
                         ids=["cli", "train_cli"])
def test_flags_are_the_jax_clis_and_device(monkeypatch, jax_main, port_main):
    assert _flags(port_main, monkeypatch) == _flags(jax_main, monkeypatch) | {"--device"}

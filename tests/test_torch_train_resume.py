"""demucs_tpu_torch's training checkpoints on the CPU: a resumed run is
bit-identical to an uninterrupted one, and a crash between the save's two
renames recovers.

These are the slowest cases of tests/test_torch_train.py (each trains the
tiny htdemucs-4s of that file for several steps, about 230 s each on one
worker), kept in a file of their own so that the suite's workers, which
take a file each (`--dist loadfile`), run them beside that file rather
than after it. They use the same model, batch and settings.
"""

import dataclasses

import numpy as np
import pytest
import torch

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S

from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_htdemucs
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.train import TrainStep, load_train_state, save_train_state

from _torch_threads import _one_torch_thread  # noqa: F401

# tests/test_torch_train.py's tiny model, segment, learning rate and EMA
TINY = dict(channels=8, bottom_channels=32, t_layers=3)
SEG = 8192
LR = 1e-3
EMA = 0.9


@pytest.fixture(scope="module")
def tiny():
    """(torch cfg, flat numpy weights, mix, refs), as tests/test_torch_train.py."""
    jcfg = dataclasses.replace(J4S, **TINY)
    flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=0)
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, SEG)) * 0.1).astype(np.float32)
    refs = (rng.standard_normal((2, jcfg.num_sources, 2, SEG)) * 0.05).astype(np.float32)
    return dataclasses.replace(HTDEMUCS_4S, **TINY), flat, mix, refs


def _model(tiny):
    cfg, flat, _, _ = tiny
    return build_htdemucs(cfg, from_jax_params(flat), "cpu", train=True)


def _batch(tiny):
    _, _, mix, refs = tiny
    return torch.from_numpy(mix), torch.from_numpy(refs)


@pytest.mark.parametrize("ema", [None, EMA], ids=["plain", "ema"])
def test_checkpoint_resume_is_exact(tiny, tmp_path, ema):
    """2 steps, save, load into a fresh model and optimizer, 2 more:
    bit-identical to 4 uninterrupted steps, the EMA included."""
    ref = TrainStep(_model(tiny), lr=LR, ema_decay=ema)
    for _ in range(4):
        ref(*_batch(tiny))

    first = TrainStep(_model(tiny), lr=LR, ema_decay=ema)
    for _ in range(2):
        first(*_batch(tiny))
    save_train_state(tmp_path / "ckpt", first)
    resumed = TrainStep(_model(tiny), lr=LR, ema_decay=ema)
    assert load_train_state(tmp_path / "ckpt", resumed) == 2
    for _ in range(2):
        resumed(*_batch(tiny))
    assert resumed.step_count == 4
    for (name, a), (_, b) in zip(ref.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(a, b), name
    if ema is not None:
        for name in ref.ema:
            assert torch.equal(ref.ema[name], resumed.ema[name]), name


def test_checkpoint_crash_between_renames_recovers(tiny, tmp_path):
    """A crash between save_train_state's two renames leaves the live
    path missing, the new state in .new and the previous one in .old:
    load takes .new, and the next save keeps it instead of deleting it."""
    step = TrainStep(_model(tiny), lr=LR)
    ck = tmp_path / "ckpt"
    step(*_batch(tiny))
    save_train_state(ck, step)                       # step 1
    step(*_batch(tiny))
    save_train_state(tmp_path / "ckpt2", step)       # step 2
    ck.rename(tmp_path / "ckpt.old")
    (tmp_path / "ckpt2").rename(tmp_path / "ckpt.new")

    fresh = TrainStep(_model(tiny), lr=LR)
    assert load_train_state(ck, fresh) == 2
    step(*_batch(tiny))
    save_train_state(ck, step)                       # step 3
    assert ck.exists()
    assert not (tmp_path / "ckpt.new").exists() and not (tmp_path / "ckpt.old").exists()
    assert load_train_state(ck, TrainStep(_model(tiny), lr=LR)) == 3

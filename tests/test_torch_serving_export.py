"""The export of the port's serving sessions (`DemixSession.export_program`
and `export_track_program`, `torch.export` serialized to bytes) on the
full-width htdemucs-4s, 16384-sample segments, on the CPU: the loaded
programs against the live model and the live fused pass (1e-6 of
scale), computing with TF32 off under any global flags, their graphs calling the kernels as `demucs_tpu_torch::` custom
ops, and both run in a subprocess that imports no model, pipeline,
serving or params module, nor anything of `demucs_tpu` or JAX."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demucs_tpu_torch import params as P
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.pipeline import ApplyOptions
from demucs_tpu_torch.serving import DemixSession

from _torch_threads import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6
SEG = 16384
STRIDE = 3 * SEG // 4
N_TRACK = 20000
N_SEG = math.ceil(N_TRACK / STRIDE)
LP = N_SEG * STRIDE


_RUNNER = '''\
"""Runs both exported programs with torch and the op registry alone."""
import sys

import numpy as np
import torch

sys.path.insert(0, sys.argv[1])
import demucs_tpu_torch.ops.cuda  # noqa: F401  (registers the custom ops)

data = np.load("io.npz")
with torch.no_grad():
    fn = torch.export.load("segment.pt2").module()
    out = fn(torch.from_numpy(data["mix"])).numpy()
    tfn = torch.export.load("track.pt2").module()
    tout = tfn(torch.from_numpy(data["track"]), torch.tensor(int(data["n_true"]))).numpy()
for got, ref in ((out, data["ref"]), (tout, data["track_ref"])):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())

banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "demucs_tpu")
                or m.split(".")[:2] in (["demucs_tpu_torch", p]
                                        for p in ("models", "pipeline", "serving", "params")))
assert not banned, banned
print("STANDALONE_OK")
'''


def _live_fused(sess, x, n_true):
    """The live fused pass of the session's Separator on x (2, LP)."""
    sep = sess._separator(ApplyOptions(segment_samples=SEG, batch_size=2, fused_track=True,
                                       max_shift_secs=0.0, shift_offset=0))
    with torch.no_grad():
        return sep._fused_track_fn(N_SEG, LP)(torch.from_numpy(x), torch.tensor(n_true)).numpy()


def _track(seed, n_true):
    """A normalized-domain track of n_true samples, zero-padded to LP."""
    x = np.zeros((2, LP), np.float32)
    x[:, :n_true] = np.random.default_rng(seed).standard_normal((2, n_true)) * 0.5
    return x


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(session, segment artifact, track artifact, standalone runner),
    exported once. The runner (`_RUNNER`, a subprocess) is started here
    on both artifacts and the live outputs, so that it loads and runs
    them beside the in-process tests; test_export_standalone_subprocess
    waits for it."""
    tmp = tmp_path_factory.mktemp("export")
    P.write_ggml(tmp / "m.bin", "htdemucs_4s",
                 P.init_flat(P.htdemucs_schema(HTDEMUCS_4S), seed=0))
    sess = DemixSession((tmp / "m.bin").read_bytes(), device="cpu")
    (tmp / "m.bin").unlink()  # full-width files are large
    blob = sess.export_program(batch_size=1, segment_samples=SEG)
    tblob = sess.export_track_program(N_TRACK, batch_size=2, segment_samples=SEG)
    mix = (np.random.default_rng(3).standard_normal((1, 2, SEG)) * 0.2).astype(np.float32)
    with torch.no_grad():
        ref = sess.model(torch.from_numpy(mix)).numpy()
    x = _track(4, N_TRACK)
    track_ref = _live_fused(sess, x, N_TRACK)
    (tmp / "segment.pt2").write_bytes(blob)
    (tmp / "track.pt2").write_bytes(tblob)
    np.savez(tmp / "io.npz", mix=mix, ref=ref, track=x, n_true=N_TRACK, track_ref=track_ref)
    (tmp / "run.py").write_text(_RUNNER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)  # the package only where the script puts it
    runner = subprocess.Popen([sys.executable, "run.py", str(REPO)], cwd=tmp, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield sess, blob, tblob, runner
    if runner.poll() is None:
        runner.kill()
        runner.communicate()
    for name in ("segment.pt2", "track.pt2"):
        (tmp / name).unlink()


@pytest.fixture(scope="module")
def loaded(exported):
    """Both artifacts loaded back: (fn(mix), fn(track, n_true))."""
    _, blob, tblob, _ = exported
    return DemixSession.load_exported(blob), DemixSession.load_exported(tblob)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * float(np.abs(ref).max()))


def test_export_program_roundtrip(exported, loaded):
    sess, blob = exported[:2]
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = loaded[0]
    mix = (np.random.default_rng(2).standard_normal((1, 2, SEG)) * 0.2).astype(np.float32)
    with torch.no_grad():
        got = fn(torch.from_numpy(mix)).numpy()
        ref = sess.model(torch.from_numpy(mix)).numpy()
    assert got.shape == (1, 4, 2, SEG)
    _close(got, ref)


@pytest.mark.parametrize("n_true", [LP - STRIDE + 1, LP])
def test_export_track_program_matches_fused_pass(exported, loaded, n_true):
    """The bucket's smallest and largest true length through one program:
    n_true is a tensor, so the tail segments' padding follows it."""
    sess = exported[0]
    fn = loaded[1]
    x = _track(n_true, n_true)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.tensor(n_true)).numpy()
    ref = _live_fused(sess, x, n_true)
    assert got.shape == (4, 2, LP)
    _close(got, ref)


def test_exported_graphs_call_the_custom_ops(loaded):
    for fn, per_call in zip(loaded, (1, math.ceil(N_SEG / 2))):
        targets = [str(n.target) for n in fn.graph.nodes if n.op == "call_function"]
        # htdemucs-4s: 10 attention calls and 32 DConv sub-blocks a model call
        assert targets.count("demucs_tpu_torch.flash_mha.default") == 10 * per_call
        assert targets.count("demucs_tpu_torch.dconv_sub_block.default") == 32 * per_call




class _FlagSpy(torch.nn.Module):
    """Calls `program`, recording the TF32 flags it runs under."""

    def __init__(self, program, seen: list):
        super().__init__()
        self.program, self.seen = program, seen

    def forward(self, *args):
        self.seen.append([f.allow_tf32 for f in _TF32_FLAGS])
        return self.program(*args)


_TF32_FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn)


def test_loaded_programs_compute_in_f32_under_any_flags(loaded, monkeypatch):
    """With both of torch's allow_tf32 flags on, each loaded program (the
    segment and the track program) runs with them off, as the live model
    does, and leaves them on after the call."""
    for flags in _TF32_FLAGS:
        monkeypatch.setattr(flags, "allow_tf32", True)
    seen = []
    seg_fn, track_fn = (type(fn)(_FlagSpy(fn.program, seen)) for fn in loaded)
    with torch.no_grad():
        seg_fn(torch.zeros(1, 2, SEG))
        track_fn(torch.from_numpy(_track(5, LP)), torch.tensor(LP))
    assert seen == [[False, False], [False, False]]
    assert [f.allow_tf32 for f in _TF32_FLAGS] == [True, True]


def test_export_standalone_subprocess(exported):
    """Both artifacts load and run in a process that has torch and the op
    registry alone, and match the live outputs there."""
    out, err = exported[3].communicate(timeout=600)
    assert exported[3].returncode == 0, err[-3000:]
    assert "STANDALONE_OK" in out

"""The port's serving sessions (`demucs_tpu_torch/serving.py`) against the
JAX package's (`demucs_tpu/serving.py`) on the same ggml bytes, at full
width on 16384-sample segments: `DemixSession.demix_segment` and
`demix_track`, within 1e-5 of max(scale, 1) (tests/test_torch_model.py's
tolerance); the dtype option and the default device, which raises
without a GPU. The bag's session is in tests/test_torch_serving_bag.py,
the export in tests/test_torch_serving_export.py."""

import numpy as np
import pytest
import torch

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.params.ggml import write_ggml as jax_write_ggml
from demucs_tpu.pipeline import ApplyOptions as JaxOptions
from demucs_tpu.serving import DemixSession as JaxSession
from demucs_tpu_torch import params as P
from demucs_tpu_torch.config import HDEMUCS_V3
from demucs_tpu_torch.pipeline import ApplyOptions
from demucs_tpu_torch.serving import BagDemixSession, DemixSession

from _torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5
SEG = 16384
STEMS = ("drums", "bass", "other", "vocals")


def _model_file(path, seed=0):
    jax_write_ggml(path, "htdemucs_4s", JP.init_flat(JP.htdemucs_schema(J4S), seed=seed))
    return path


@pytest.fixture(scope="module")
def model_bytes(tmp_path_factory):
    path = _model_file(tmp_path_factory.mktemp("serving") / "m.bin")
    data = path.read_bytes()
    path.unlink()  # full-width files are large; the suite keeps its temp dirs
    return data


@pytest.fixture(scope="module")
def sessions(model_bytes):
    return DemixSession(model_bytes, device="cpu"), JaxSession(model_bytes)


def _close(got, ref):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def _lr(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(SEG) * 0.2).astype(np.float32) for _ in range(2)]


def test_session_demix_segment_matches_jax(sessions):
    port, jax_sess = sessions
    assert port.sources == jax_sess.sources == STEMS
    left, right = _lr(0)
    got, ref = port.demix_segment(left, right), jax_sess.demix_segment(left, right)
    assert set(got) == set(STEMS)
    for name in STEMS:
        assert got[name][0].shape == got[name][1].shape == (SEG,)
        _close(np.stack(got[name]), np.stack(ref[name]))


def test_session_demix_track_matches_jax(sessions):
    port, jax_sess = sessions
    rng = np.random.default_rng(1)
    track = (rng.standard_normal((2, 24000)) * 0.2).astype(np.float32)
    got = port.demix_track(track, ApplyOptions(segment_samples=SEG, batch_size=2,
                                               shift_offset=0))
    ref = jax_sess.demix_track(track, JaxOptions(segment_samples=SEG, batch_size=2,
                                                 shift_offset=0))
    assert got.shape == (4, 2, 24000)
    _close(got, np.asarray(ref))
    # one Separator per options snapshot, reused
    opts = ApplyOptions(segment_samples=SEG, batch_size=2, shift_offset=0)
    assert port._separator(opts) is port._separator(ApplyOptions(
        segment_samples=SEG, batch_size=2, shift_offset=0))
    many = port.demix_tracks([track, track[:, :20000]], opts)
    np.testing.assert_array_equal(many[0], got)


def test_export_program_hdemucs_mmi(tmp_path):
    """hdemucs_mmi's segment program (a v3 file: K6, K5 and K4 as custom
    ops, the BiLSTM's packing recorded in the program) against the live
    model, 1e-6 of scale."""
    path = tmp_path / "v3.bin"
    P.write_ggml(path, "hdemucs_mmi", P.init_flat(P.hdemucs_v3_schema(HDEMUCS_V3), seed=0))
    sess = DemixSession(path, device="cpu")
    path.unlink()
    fn = DemixSession.load_exported(sess.export_program(batch_size=1, segment_samples=8192))
    ops = {str(n.target) for n in fn.graph.nodes if str(n.target).startswith("demucs_tpu_torch")}
    assert ops == {f"demucs_tpu_torch.{k}.default"
                   for k in ("bilstm_recurrence", "dconv_sub_block", "gn_glu_scale_res")}
    mix = torch.from_numpy(np.stack(_lr(5))[None, :, :8192].copy())
    with torch.no_grad():
        got, ref = fn(mix).numpy(), sess.model(mix).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * float(np.abs(ref).max()))


def test_session_dtype_and_default_device(model_bytes, tmp_path, monkeypatch):
    bf16 = DemixSession(model_bytes, dtype=torch.bfloat16, device="cpu")
    assert bf16.model.encoder[0].conv.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        DemixSession(model_bytes, dtype=torch.float16, device="cpu")
    # the default device is the GPU: without one, a session raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        DemixSession(model_bytes)
    with pytest.raises(RuntimeError, match="no GPU"):
        BagDemixSession(tmp_path)

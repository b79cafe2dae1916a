"""The port's `BagDemixSession` (`demucs_tpu_torch/serving.py`) against
the JAX package's on the same four ggml files (full-width htdemucs-4s,
seeds 0-3, named htdemucs_ft_{stem}.bin): `demix_segment` at 16384
samples within 1e-5 of max(scale, 1) (tests/test_torch_model.py's
tolerance). Most of its time is the JAX bag's one compile."""

import numpy as np

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.params.ggml import write_ggml as jax_write_ggml
from demucs_tpu.serving import BagDemixSession as JaxBagSession
from demucs_tpu_torch.serving import BagDemixSession

from _torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5
SEG = 16384
STEMS = ("drums", "bass", "other", "vocals")


def test_bag_session_matches_jax(tmp_path):
    for i, stem in enumerate(STEMS):
        jax_write_ggml(tmp_path / f"htdemucs_ft_{stem}.bin", "htdemucs_4s",
                       JP.init_flat(JP.htdemucs_schema(J4S), seed=i))
    port, jax_bag = BagDemixSession(tmp_path, device="cpu"), JaxBagSession(tmp_path)
    for path in tmp_path.glob("*.bin"):
        path.unlink()  # loaded; full-width files are large
    assert port.sources == STEMS
    rng = np.random.default_rng(2)
    left, right = ((rng.standard_normal(SEG) * 0.2).astype(np.float32) for _ in range(2))
    got, ref = port.demix_segment(left, right), jax_bag.demix_segment(left, right)
    for name in STEMS:
        ref_lr = np.stack(ref[name])
        scale = max(float(np.abs(ref_lr).max()), 1.0)
        np.testing.assert_allclose(np.stack(got[name]), ref_lr, rtol=0, atol=TOL * scale)

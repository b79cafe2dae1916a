"""demucs_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker `cuda`) and skips
without one. This file imports neither JAX nor demucs_tpu, so it also
runs where JAX is absent (the repository's conftest imports JAX; run it
there with --noconftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from demucs_tpu_torch.ops.cuda import flash_mha, flash_mha_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max|plain|


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 48])
@pytest.mark.parametrize("T,S", [(70, 45), (1, 1), (64, 32), (130, 257)])
def test_flash_mha_matches_plain(gen, dtype, D, T, S):
    """Ragged lengths around the kernel's 64-row and 64-key tiles."""
    q, k, v = (torch.randn(2, 3, n, D, device="cuda", generator=gen).to(dtype)
               for n in (T, S, S))
    before = flash_mha.launches
    out = flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_mha_plain(q, k, v).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


def test_flash_mha_large_logits_stable(gen):
    q, k, v = (torch.randn(1, 1, 100, 64, device="cuda", generator=gen) * s
               for s in (30.0, 30.0, 1.0))
    out = flash_mha(q, k, v)
    ref = flash_mha_plain(q, k, v)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_flash_mha_rejects_what_it_cannot_run(gen):
    q = torch.randn(1, 2, 16, 32, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head dim"):
        flash_mha(q, q, q)
    q = torch.randn(1, 2, 16, 64, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mha(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="dtype"):
        flash_mha(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="devices"):
        flash_mha(q, q.cpu(), q)

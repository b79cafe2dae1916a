"""demucs_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker `cuda`) and skips
without one. This file imports neither JAX nor demucs_tpu, so it also
runs where JAX is absent (the repository's conftest imports JAX; run it
there with --noconftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from demucs_tpu_torch.ops.attention import _sdpa
from demucs_tpu_torch.ops.cuda import (flash_mha, flash_mha_bwd, flash_mha_bwd_plain,
                                       flash_mha_fwd, flash_mha_fwd_plain, flash_mha_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max|plain|
# the backward's dq sums over S tiles with atomics (order varies between
# runs) and all three gradients sum over one more axis than the forward
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RAGGED = [(70, 45), (1, 1), (64, 32), (130, 257)]


def _rel_err(out, ref, floor=1e-30):
    """max|out - ref| over max(max|ref|, floor). At S = 1 the softmax is 1,
    so dS and with it dq and dk are 0 up to rounding: there the gradients
    take a floor of 1, the inputs' scale."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item() / max(ref.abs().max().item(), floor)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 48])
@pytest.mark.parametrize("T,S", RAGGED)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 48])
@pytest.mark.parametrize("T,S", RAGGED)
def test_flash_mha_fwd_matches_plain(gen, dtype, D, T, S):
    """K2: the output and the per-row lse at ragged lengths."""
    q, k, v = (torch.randn(2, 3, n, D, device="cuda", generator=gen).to(dtype)
               for n in (T, S, S))
    before = (flash_mha.launches, flash_mha_fwd.launches)
    out, lse = flash_mha_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (flash_mha.launches, flash_mha_fwd.launches) == (before[0], before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, T)
    ref, ref_lse = flash_mha_fwd_plain(q, k, v)
    assert _rel_err(out, ref) <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * ref_lse.abs().max().item() + 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 48])
@pytest.mark.parametrize("T,S", RAGGED)
def test_flash_mha_bwd_matches_plain(gen, dtype, D, T, S):
    """K3 against its plain twin on the same q, k, v, o, lse and dO."""
    q, k, v = (torch.randn(2, 3, n, D, device="cuda", generator=gen).to(dtype)
               for n in (T, S, S))
    do = torch.randn(2, 3, T, D, device="cuda", generator=gen).to(dtype)
    o, lse = flash_mha_fwd_plain(q, k, v)
    before = flash_mha_bwd.launches
    grads = flash_mha_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash_mha_bwd.launches == before + 1
    refs = flash_mha_bwd_plain(q, k, v, o, lse, do)
    floor = 1.0 if S == 1 else 1e-30
    for name, g, r, x in zip("qkv", grads, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert _rel_err(g, r, floor) <= TOL_BWD[dtype], (name, _rel_err(g, r, floor))


def test_flash_mha_fwd_lse_at_large_logits(gen):
    """K2 keeps its softmax statistics in the log2 domain; the lse it
    returns is the natural log, which this pins where logits reach ~1e3."""
    q, k, v = (torch.randn(1, 2, 100, 64, device="cuda", generator=gen) * s
               for s in (30.0, 30.0, 1.0))
    out, lse = flash_mha_fwd(q, k, v)
    ref, ref_lse = flash_mha_fwd_plain(q, k, v)
    assert ref_lse.abs().max().item() > 100.0
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    # one rounding of a logit s moves its weight by |s| eps relative, and
    # the output (a convex combination of v's rows) by at most twice the
    # largest such move times max|v|
    logit_max = (q @ k.transpose(-1, -2)).abs().max().item() / 8.0
    atol = 2 * torch.finfo(torch.float32).eps * logit_max * v.abs().max().item()
    assert logit_max > 1e3
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_sdpa_gradients_through_kernels(gen):
    """backward() through ops.attention._sdpa on CUDA goes through K2 and
    K3 (not K1) and gives the gradients of the plain attention."""
    B, T, S, H, D = 2, 70, 45, 4, 64
    Q, K, V = (torch.randn(B, n, H, D, device="cuda", generator=gen)
               for n in (T, S, S))
    w = torch.randn(B, T, H, D, device="cuda", generator=gen)

    def grads(fn):
        xs = [x.clone().requires_grad_() for x in (Q, K, V)]
        (fn(*xs) * w).sum().backward()
        return [x.grad for x in xs]

    counts = [kern.launches for kern in (flash_mha, flash_mha_fwd, flash_mha_bwd)]
    ours = grads(_sdpa)
    assert [kern.launches for kern in (flash_mha, flash_mha_fwd, flash_mha_bwd)] == \
        [counts[0], counts[1] + 1, counts[2] + 1]

    def plain(q, k, v):
        tr = lambda x: x.transpose(1, 2)  # noqa: E731
        return tr(flash_mha_plain(tr(q), tr(k), tr(v)))

    for name, g, r in zip("QKV", ours, grads(plain)):
        assert g is not None, name
        assert _rel_err(g, r) <= TOL_BWD[torch.float32], (name, _rel_err(g, r))
    with torch.no_grad():
        before = flash_mha.launches
        _sdpa(Q, K, V)
        assert flash_mha.launches == before + 1


def test_launchers_refuse_to_drop_gradients(gen):
    """The raw launchers write through pointers: under grad mode, with an
    input that requires grad, they raise instead of returning a result
    without history."""
    q = torch.randn(1, 2, 16, 64, device="cuda", generator=gen).requires_grad_()
    k = torch.randn(1, 2, 16, 64, device="cuda", generator=gen)
    with pytest.raises(RuntimeError, match="FlashSDPA"):
        flash_mha(q, k, k)
    with pytest.raises(RuntimeError, match="FlashSDPA"):
        flash_mha_fwd(q, k, k)
    o, lse = flash_mha_fwd_plain(q.detach(), k, k)
    with pytest.raises(RuntimeError, match="FlashSDPA"):
        flash_mha_bwd(q, k, k, o, lse, o)
    with torch.no_grad():
        flash_mha(q, k, k)
        flash_mha_bwd(q, k, k, o, lse, o)

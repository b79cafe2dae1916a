"""demucs_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker `cuda`) and skips
without one. This file imports neither JAX nor demucs_tpu, so it also
runs where JAX is absent (the repository's conftest imports JAX; run it
there with --noconftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demucs_tpu_torch import params as TP
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S, HTDEMUCS_6S
from demucs_tpu_torch.models import build_bag, build_hdemucs_v3, build_htdemucs, build_model
from demucs_tpu_torch.ops import DConvSubBlock
from demucs_tpu_torch.ops.attention import _sdpa
from demucs_tpu_torch.ops.cuda import (KERNELS, bilstm_recurrence, bilstm_recurrence_plain,
                                       dconv_sub_block, dconv_sub_block_plain, flash_mha,
                                       flash_mha_bwd, flash_mha_bwd_plain, flash_mha_fwd,
                                       flash_mha_fwd_plain, flash_mha_plain, gn_glu_scale_res,
                                       gn_glu_scale_res_plain, int8_matmul, int8_matmul_plain)
from demucs_tpu_torch.ops.cuda.dconv import card_capacity, dconv_plan
from demucs_tpu_torch.ops.cuda.quant_matmul import QuantPlan, launch_plan, quant_plan
from demucs_tpu_torch.pipeline import PCM16_TRANSFER_SCALE, ApplyOptions, Separator
from demucs_tpu_torch.streaming import StreamingSeparator
from demucs_tpu_torch.train import TrainStep, load_train_state, save_train_state
from demucs_tpu_torch.utils.device import f32_precision
from demucs_tpu_torch.utils.progress import TimedProgress

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max|plain|
# all three gradients sum over one more axis than the forward
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# ragged lengths around the tiles: K1/K2 take 128 query rows per block (two
# warpgroups of 64) and 64 keys per tile, K3 64 keys per block and 32 query
# rows per T tile, the tiles taken in turns by two consumer warpgroups
RAGGED = [(70, 45), (1, 1), (64, 32), (130, 257), (129, 65), (640, 641)]
# K3 also at lengths that end mid-tile for both of its consumers: 200 rows
# are 6 full tiles and 8 rows (7 tiles, the last one consumer 0's), 136 keys
# two blocks and 8 keys; 96 rows are 3 tiles (the last one consumer 0's alone)
BWD_RAGGED = RAGGED + [(200, 136), (96, 200), (33, 64)]


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
@pytest.mark.parametrize("T,S", BWD_RAGGED)
def test_flash_mha_bwd_matches_plain(gen, dtype, D, T, S):
    """K3 against its plain twin on the same q, k, v, o, lse and dO. B*H = 6
    makes a grid of 6 x ceil(S / 64) blocks: a partial wave of the SMs."""
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


@pytest.mark.parametrize("B,H,T,S,D,dtype", [(4, 8, 2688, 2688, 64, torch.float32),
                                             (2, 3, 130, 257, 48, torch.bfloat16)],
                         ids=["training-f32", "ragged-bf16"])
def test_flash_mha_bwd_is_bit_reproducible(gen, B, H, T, S, D, dtype):
    """dq sums over the 64-key tiles in a fixed order (per-tile partials,
    no atomics): two calls on one input give bit-identical dq, dk and dv,
    at the training path's largest call and at a ragged shape."""
    q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen).to(dtype)
               for n in (T, S, S))
    do = torch.randn(B, H, T, D, device="cuda", generator=gen).to(dtype)
    o, lse = flash_mha_fwd(q, k, v)
    first = flash_mha_bwd(q, k, v, o, lse, do)
    second = flash_mha_bwd(q, k, v, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_mha_fwd_is_bit_reproducible(gen, dtype):
    """K2 uses no atomics and no order that depends on scheduling: two
    calls on one input give the same out and lse bit for bit, at the
    training path's largest call (the resumed training run is held
    bit-exact against the uninterrupted one, and K3 rebuilds P from lse)."""
    q, k, v = (torch.randn(4, 8, 2688, 64, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    first, second = flash_mha_fwd(q, k, v), flash_mha_fwd(q, k, v)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_flash_mha_fwd_kernels_run_on_tensor_cores(gen):
    """Read the SASS of the built library: every instantiation of both
    forward kernels (K1 mha_fwd_kernel, K2 mha_fwd_lse_kernel) issues
    warpgroup MMAs (HGMMA) and no CUDA-core FMA loop does the products."""
    from demucs_tpu_torch.ops.cuda import build

    build.load("flash_mha")
    counts = build.sass_counts("flash_mha", "HGMMA")
    for kernel in ("mha_fwd_kernel", "mha_fwd_lse_kernel"):
        found = {f: n for f, n in counts.items() if kernel in f}
        assert len(found) == 4, (kernel, list(counts))  # {f32, bf16} x D {48, 64}
        assert all(n > 0 for n in found.values()), found


def test_flash_mha_bwd_kernel_runs_on_tensor_cores(gen):
    """Read the SASS of the built library: every instantiation of K3's
    kernel (mha_bwd_kernel, f32 and bf16, D 48 and 64) issues warpgroup MMAs
    (HGMMA); its dq reduction issues none."""
    from demucs_tpu_torch.ops.cuda import build

    build.load("flash_mha_bwd")
    counts = build.sass_counts("flash_mha_bwd", "HGMMA")
    found = {f: n for f, n in counts.items() if "mha_bwd_kernel" in f}
    assert len(found) == 4, list(counts)
    assert all(n > 0 for n in found.values()), found


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


# --- K6: the BiLSTM recurrence -------------------------------------------------

def _lstm_operands(gen, T, B, H):
    """Projected inputs at unit scale and recurrent weights at 1/sqrt(H),
    the scale of a trained layer's gate pre-activations."""
    xs = torch.randn(T, 2, B, 4 * H, device="cuda", generator=gen)
    w_hh = torch.randn(2, H, 4 * H, device="cuda", generator=gen) / H ** 0.5
    return xs, w_hh


@pytest.mark.parametrize("T,B,H", [(336, 1, 192), (336, 2, 192), (168, 1, 384),
                                   (168, 2, 384), (37, 2, 16), (37, 5, 16), (336, 8, 192),
                                   (168, 8, 384), (168, 9, 384), (60, 9, 100), (60, 3, 100),
                                   (40, 8, 512), (40, 1, 512)])
def test_bilstm_recurrence_matches_plain(gen, T, B, H):
    """The v3 shapes (encoder 4: T=336, H=192; encoder 5: T=168, H=384) at
    batch 1, 2 and 8 and at 9 (two clusters per direction, the second
    mostly padding), a ragged small case, batches that pad a group of 8
    rows, H = 100 (no multiple of the cluster size: the last blocks own
    padding units) and H = 512 (whose slice of w_hh does not all fit
    shared memory: the rest is read from L2); h lies in (-1, 1), so the
    tolerance is absolute."""
    xs, w_hh = _lstm_operands(gen, T, B, H)
    before = bilstm_recurrence.launches
    ys = bilstm_recurrence(xs, w_hh)
    torch.cuda.synchronize()
    assert bilstm_recurrence.launches == before + 1
    assert ys.shape == (T, 2, B, H) and ys.dtype == torch.float32
    err = (ys - bilstm_recurrence_plain(xs, w_hh)).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("T,B,H", [(168, 2, 384), (336, 9, 192)])
def test_bilstm_recurrence_is_bit_reproducible(gen, T, B, H):
    """Every sum of K6 has one fixed order: two calls on one input agree
    bit for bit."""
    xs, w_hh = _lstm_operands(gen, T, B, H)
    assert torch.equal(bilstm_recurrence(xs, w_hh), bilstm_recurrence(xs, w_hh))


def test_bilstm_recurrence_rejects_what_it_cannot_run(gen):
    xs, w_hh = _lstm_operands(gen, 8, 2, 16)
    with pytest.raises(ValueError, match="f32"):  # f32 or bf16, of one dtype
        bilstm_recurrence(xs.half(), w_hh.half())
    with pytest.raises(ValueError, match="f32"):
        bilstm_recurrence(xs.bfloat16(), w_hh)
    with pytest.raises(ValueError, match="w_hh"):
        bilstm_recurrence(xs, w_hh[:, :8].contiguous())
    with pytest.raises(ValueError, match="xs"):
        bilstm_recurrence(xs[:, :1].contiguous(), w_hh)
    with pytest.raises(ValueError, match="contiguous"):
        bilstm_recurrence(xs.transpose(0, 2).contiguous().transpose(0, 2), w_hh)
    with pytest.raises(ValueError, match="H="):
        bilstm_recurrence(*_lstm_operands(gen, 2, 1, 520))
    before = bilstm_recurrence.launches
    with pytest.raises(RuntimeError, match="gradient"):
        bilstm_recurrence(xs, w_hh.clone().requires_grad_())
    assert bilstm_recurrence.launches == before
    with torch.no_grad():
        bilstm_recurrence(xs, w_hh.clone().requires_grad_())
    assert bilstm_recurrence.launches == before + 1


def test_hdemucs_v3_gpu_matches_cpu(gen):
    """hdemucs_mmi at full width: K6, cuDNN and cuBLAS (TF32 off) on the
    GPU against the plain twin on the CPU, within 3e-4 of the output's
    scale (the tolerance tests/test_model_v3.py allows), with 8 K6, 16 K5
    and 4 K4 launches for the one batch."""
    schema = TP.hdemucs_v3_schema(HDEMUCS_V3)
    sd = TP.from_state_dict(TP.init_flat(schema, seed=0), schema)
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    kernels = (bilstm_recurrence, dconv_sub_block, gn_glu_scale_res)
    for device in ("cuda", "cpu"):
        model = build_hdemucs_v3(HDEMUCS_V3, sd, device)
        before = [k.launches for k in kernels]
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
        # K6: encoders 4, 5 x 2 sub-blocks x 2 layers; K5: encoders 0-3 x
        # 2 branches x 2 sub-blocks; K4: encoders 4, 5 x 2 sub-blocks
        want = (8, 16, 4) if device == "cuda" else (0, 0, 0)
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == want
    assert np.isfinite(outs["cuda"]).all()
    diff = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert diff < 3e-4 * max(np.abs(outs["cpu"]).max(), 1.0), diff


# --- K5 and K4: the fused DConv sub-block and its tail ---------------------------

def _dconv_operands(gen, N, C, h, T):
    """x and one sub-block's weights at the scale of a trained layer's."""
    def r(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + offset
    x = r(N, C, T, scale=0.5, offset=0.1)
    ws = [r(h, C, 3, scale=0.3), r(h, scale=0.2), r(h, scale=0.2, offset=1.0),
          r(h, scale=0.2), r(2 * C, h, 1, scale=0.3), r(2 * C, scale=0.2),
          r(2 * C, scale=0.2, offset=1.0), r(2 * C, scale=0.2), r(C, scale=0.1)]
    return x, ws


# (N, C, h, T, dil): ragged T, N = 1, T below the halo's 2 dil + 1, channel
# counts that are no multiple of the kernel's 6- and 8-row warp tiles or of
# 4 (C = 5, h = 3), and every form of K5 and its edges: a row that just fits
# one block (C = 96, h = 24, T = 356: 231,856 shared bytes) and one that
# just does not (T = 360: a cluster); frequency rows over clusters at both
# families' hidden widths (C = 192 with h = 24 and 48, C = 384 with h = 48
# and 96) with dilation 2, so that the halo crosses a slice; w0 and w3
# staged in chunks (C = 384, h = 96); time rows in tiles whose T is no
# multiple of the tile (T = 21499, 85995; T = 21499 is also no multiple
# of 4: 4-byte copies) or spans a cluster of wide slices (T = 5375), and
# time3 (C = 384, T = 1344) with y's and z's rows split over blocks
DCONV_SHAPES = [(2, 48, 6, 70, 1), (1, 48, 6, 70, 2), (3, 8, 2, 4, 2), (1, 5, 3, 1, 1),
                (16, 384, 96, 336, 1), (8, 192, 24, 336, 2), (1, 96, 12, 21499, 2),
                (2, 48, 12, 5375, 1), (2, 48, 6, 85995, 1),
                (3, 96, 24, 356, 2), (3, 96, 24, 360, 2),
                (4, 192, 24, 336, 2), (4, 192, 48, 336, 2), (2, 384, 48, 336, 2),
                (2, 384, 96, 336, 2), (2, 384, 48, 1344, 2)]
# a --stream call's shapes (one segment, B = 1) at full width: every DConv
# level of htdemucs-4s (h = C/8) and hdemucs_mmi (h = C/4), dilations 1 and
# 2; frequency levels fold {512, 128, 32, 8} rows of 336 frames
DCONV_SHAPES += [shape for shape in (
    (N, C, C // comp, T, dil)
    for comp in (8, 4) for dil in (1, 2)
    for N, C, T in ((512, 48, 336), (128, 96, 336), (32, 192, 336), (8, 384, 336),
                    (1, 48, 85995), (1, 96, 21499), (1, 192, 5375), (1, 384, 1344)))
    if shape not in DCONV_SHAPES]


@pytest.fixture
def f32():
    """The plain twins' convolutions in f32: cuDNN runs them in TF32 by
    default."""
    with f32_precision():
        yield


@pytest.mark.parametrize("N,C,h,T,dil", DCONV_SHAPES)
def test_dconv_sub_block_matches_plain(gen, f32, N, C, h, T, dil):
    x, ws = _dconv_operands(gen, N, C, h, T)
    before = dconv_sub_block.launches
    out = dconv_sub_block(x, *ws, dil)
    torch.cuda.synchronize()
    assert dconv_sub_block.launches == before + 1
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _rel_err(out, dconv_sub_block_plain(x, *ws, dil)) <= TOL[torch.float32]


# one shape of each form of K5: (N, C, h, T, dil, form)
DCONV_FORMS = [(2, 48, 6, 70, 1, "row"), (2, 384, 48, 336, 2, "cluster"),
               (2, 48, 6, 85995, 1, "tiles")]


@pytest.mark.parametrize("N,C,h,T,dil,form", DCONV_FORMS, ids=[f[-1] for f in DCONV_FORMS])
def test_dconv_sub_block_is_bit_reproducible(gen, N, C, h, T, dil, form):
    """Each form sums its statistics in a fixed order (the cluster's ranks
    in order, the tiles' partial sums in order): two calls agree bit for
    bit."""
    assert dconv_plan(N, C, h, T, dil, capacity=card_capacity).form == form
    x, ws = _dconv_operands(gen, N, C, h, T)
    first = dconv_sub_block(x, *ws, dil)
    assert torch.equal(first, dconv_sub_block(x, *ws, dil))


def _tail_operands(gen, R, C, T):
    x = torch.randn(R, 2 * C, T, device="cuda", generator=gen) + 0.3
    res = torch.randn(R, C, T, device="cuda", generator=gen)
    w = torch.randn(2 * C, device="cuda", generator=gen) * 0.2 + 1.0
    b = torch.randn(2 * C, device="cuda", generator=gen) * 0.2
    scale = torch.randn(C, device="cuda", generator=gen) * 0.1
    return x, w, b, scale, res


@pytest.mark.parametrize("R,C,T", [(1, 4, 37), (2, 768, 336), (2, 1536, 168), (3, 5, 1),
                                   (8, 768, 336), (8, 1536, 168), (1, 768, 1344),
                                   (1, 768, 336), (1, 1536, 168)])
def test_gn_glu_scale_res_matches_plain(gen, R, C, T):
    """The v3 encoder-4/5 tails (C = 768, T = 336; C = 1536, T = 168) at B =
    1 (a stream call), 2 and 8, small ragged rows and a longer row."""
    args = _tail_operands(gen, R, C, T)
    before = gn_glu_scale_res.launches
    out = gn_glu_scale_res(*args)
    torch.cuda.synchronize()
    assert gn_glu_scale_res.launches == before + 1
    assert out.shape == args[-1].shape
    assert _rel_err(out, gn_glu_scale_res_plain(*args)) <= TOL[torch.float32]


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("C,T", [(768, 336), (1536, 168)], ids=["enc4", "enc5"])
def test_gn_glu_scale_res_is_bit_reproducible(gen, C, T, B):
    """K4 at both tails gives the same bits on repeat: the partial sums are
    reduced in a fixed order."""
    args = _tail_operands(gen, B, C, T)
    assert torch.equal(gn_glu_scale_res(*args), gn_glu_scale_res(*args))


def test_dconv_function_gradients(gen, f32):
    """Two sub-blocks through DConvSubBlock (forward K5, backward autograd
    through the recomputed twin) against autograd through the twin alone,
    on the card: the output, and the gradients of x and every weight."""
    N, C, h, T = 3, 48, 6, 200
    x, _ = _dconv_operands(gen, N, C, h, T)
    blocks = [_dconv_operands(gen, N, C, h, T)[1] for _ in range(2)]
    cot = torch.randn(N, C, T, device="cuda", generator=gen)

    def run(fn):
        xs = x.clone().requires_grad_()
        wss = [[w.clone().requires_grad_() for w in ws] for ws in blocks]
        out = xs
        for j, ws in enumerate(wss):
            out = fn(out, *ws, 2 ** j)
        (out * cot).sum().backward()
        return out.detach(), [xs.grad] + [w.grad for ws in wss for w in ws]

    before = dconv_sub_block.launches
    out, grads = run(DConvSubBlock.apply)
    assert dconv_sub_block.launches == before + 2
    ref, refs = run(dconv_sub_block_plain)
    assert dconv_sub_block.launches == before + 2
    assert _rel_err(out, ref) <= TOL[torch.float32]
    top = max(r.abs().max().item() for r in refs)
    for i, (g, r) in enumerate(zip(grads, refs)):
        assert g is not None, i
        err = (g - r).abs().max().item()
        assert err <= 1e-5 * (r.abs().max().item() + top), (i, err)


def test_dconv_launchers_refuse_grad_and_bad_operands(gen):
    x, ws = _dconv_operands(gen, 2, 8, 2, 30)
    y = torch.randn(2, 16, 30, device="cuda", generator=gen)
    before = (dconv_sub_block.launches, gn_glu_scale_res.launches)
    with pytest.raises(RuntimeError, match="gradient"):
        dconv_sub_block(x.clone().requires_grad_(), *ws, 1)
    with pytest.raises(RuntimeError, match="gradient"):
        gn_glu_scale_res(y, ws[6].clone().requires_grad_(), ws[7], ws[8], x)
    with pytest.raises(ValueError, match="f32"):  # f32 or bf16, of one dtype
        dconv_sub_block(x.half(), *(w.half() for w in ws), 1)
    with pytest.raises(ValueError, match="f32"):
        dconv_sub_block(x.bfloat16(), *ws, 1)
    with pytest.raises(ValueError, match="w0"):
        dconv_sub_block(x, ws[0][:, :4].contiguous(), *ws[1:], 1)
    with pytest.raises(ValueError, match="contiguous"):
        dconv_sub_block(x.transpose(1, 2).contiguous().transpose(1, 2), *ws, 1)
    with pytest.raises(ValueError, match="res"):
        gn_glu_scale_res(y, ws[6], ws[7], ws[8], x[:, :4].contiguous())
    with pytest.raises(ValueError, match="scale"):
        gn_glu_scale_res(y, ws[6], ws[7], ws[8][:4].contiguous(), x)
    assert (dconv_sub_block.launches, gn_glu_scale_res.launches) == before
    with torch.no_grad():
        dconv_sub_block(x.clone().requires_grad_(), *ws, 1)
        gn_glu_scale_res(y, ws[6].clone().requires_grad_(), ws[7], ws[8], x)
    assert (dconv_sub_block.launches, gn_glu_scale_res.launches) == (before[0] + 1,
                                                                    before[1] + 1)


# --- K7: the int8-dequant matmul --------------------------------------------------

def _int8_operands(gen, M, N, K):
    """x at unit scale, a weight at 1/sqrt(K) quantized per output channel,
    a small bias."""
    x = torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5
    scale = torch.clamp(w.abs().amax(1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return x, q, scale, torch.randn(N, device="cuda", generator=gen) * 0.01


# (M, N, K): htdemucs-4s's linears at B = 2 (5376 frequency and 2688 time
# tokens; Q/K/V/output projections (512, 512), linear1 (K 512, N 2048),
# linear2 (K 2048, N 512)), hdemucs_mmi's BiLSTM output linears at B = 2
# (672 x 384 -> 192, 336 x 768 -> 384), a ragged M, M, N and K ragged
# around the 128 x 64 x 16 tiles (K % 4 != 0 takes the element-wise loads),
# and wgmma shapes with K % 32 == 16 (a last half stage loaded as zeros), an
# odd N (unpaired columns stored one at a time) and a ragged M
INT8_SHAPES = [(5376, 512, 512), (2688, 2048, 512), (5376, 512, 2048), (672, 192, 384),
               (336, 384, 768), (1000, 512, 512), (130, 70, 37), (1, 1, 1), (129, 65, 17),
               (257, 66, 20), (70, 97, 48), (130, 65, 16), (257, 129, 80)]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("M,N,K", INT8_SHAPES)
def test_int8_matmul_matches_plain(gen, f32, M, N, K, bias):
    """Every shape with K % 16 == 0 (every path shape) takes the tensor
    cores, the rest the CUDA cores; the call is counted under its form."""
    x, q, scale, b = _int8_operands(gen, M, N, K)
    b = b if bias else None
    form = "wgmma" if K % 16 == 0 else "simt"
    assert quant_plan(M, N, K, x.data_ptr(), q.data_ptr()).form == form
    before = int8_matmul.launches, dict(int8_matmul.form_launches)
    y = int8_matmul(x, q, scale, b)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before[0] + 1
    assert int8_matmul.form_launches[form] == before[1][form] + 1
    assert y.shape == (M, N) and y.dtype == torch.float32
    assert _rel_err(y, int8_matmul_plain(x, q, scale, b)) <= TOL[torch.float32]


# every INT8_SHAPES case in every form that can take it: the wgmma form with
# 128 and with 64 rows per block (K % 16 == 0), and the simt form
INT8_FORMS = [(M, N, K, form) for M, N, K in INT8_SHAPES
              for form in (("wgmma128", "wgmma64") if K % 16 == 0 else ()) + ("simt",)]


@pytest.mark.parametrize("M,N,K,form", INT8_FORMS)
def test_int8_matmul_each_form_matches_plain(gen, f32, M, N, K, form):
    """Each form and tile height against the twin, and the same bits on
    repeat (no atomics)."""
    x, q, scale, b = _int8_operands(gen, M, N, K)
    if form == "simt":
        plan = QuantPlan("simt", 128, 64, K % 4 == 0, M, N)
    else:
        plan = QuantPlan("wgmma", int(form[5:]), 128, False, M, N)
    y = launch_plan(x, q, scale, b, plan)
    assert _rel_err(y, int8_matmul_plain(x, q, scale, b)) <= TOL[torch.float32]
    assert torch.equal(y, launch_plan(x, q, scale, b, plan))


def test_int8_matmul_kernels_run_on_tensor_cores(gen):
    """Every instantiation of the wgmma form (both tile heights in both
    weight modes) issues warpgroup MMAs (HGMMA in their SASS); the simt
    form's four none."""
    from demucs_tpu_torch.ops.cuda import build

    build.load("quant_matmul")
    counts = build.sass_counts("quant_matmul", "HGMMA")
    wgmma = {k: n for k, n in counts.items() if "int8_matmul_wgmma_kernel" in k}
    simt = {k: n for k, n in counts.items() if "int8_matmul_simt_kernel" in k}
    assert len(wgmma) == 4 and all(wgmma.values()), counts
    assert len(simt) == 4 and not any(simt.values()), counts


def test_int8_matmul_unaligned_x(gen, f32):
    """x at an offset that is no multiple of 16 bytes takes the simt form's
    element-wise loads though K % 16 == 0."""
    M, N, K = 70, 96, 64
    _, q, scale, b = _int8_operands(gen, M, N, K)
    x = torch.randn(M * K + 1, device="cuda", generator=gen)[1:].view(M, K)
    assert x.data_ptr() % 16
    assert quant_plan(M, N, K, x.data_ptr(), q.data_ptr()).form == "simt"
    y = int8_matmul(x, q, scale, b)
    assert _rel_err(y, int8_matmul_plain(x, q, scale, b)) <= TOL[torch.float32]


def test_int8_matmul_refuses_grad_and_bad_operands(gen):
    x, q, scale, b = _int8_operands(gen, 8, 16, 32)
    before = int8_matmul.launches
    with pytest.raises(RuntimeError, match="gradient"):
        int8_matmul(x.clone().requires_grad_(), q, scale, b)
    with pytest.raises(RuntimeError, match="gradient"):
        int8_matmul(x, q, scale, b.clone().requires_grad_())
    with pytest.raises(ValueError, match=r"q as torch\.int8"):
        int8_matmul(x, q.float(), scale, b)
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x, q, scale[:8].contiguous(), b)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x.t().contiguous().t(), q, scale, b)
    with pytest.raises(ValueError, match="q"):
        int8_matmul(x, q[:, :16].contiguous(), scale, b)
    assert int8_matmul.launches == before
    with torch.no_grad():
        int8_matmul(x.clone().requires_grad_(), q, scale, b)
    assert int8_matmul.launches == before + 1


def test_int8_htdemucs_gpu_matches_cpu(gen):
    """htdemucs-4s at full width with int8 weights: K7 on the GPU against
    its plain twin on the CPU, within 3e-4 of the output's scale, with 60
    K7 (all in the wgmma form), 10 K1 and 32 K5 launches for the one batch;
    the quantized weights stay int8 on the card."""
    schema = TP.htdemucs_schema(HTDEMUCS_4S)
    sd = TP.quantize_int8(TP.from_state_dict(TP.init_flat(schema, seed=0), schema))
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    kernels = (int8_matmul, flash_mha, dconv_sub_block)
    for device in ("cuda", "cpu"):
        model = build_htdemucs(HTDEMUCS_4S, sd, device)
        w = model.crosstransformer.layers[0].linear1.weight
        assert w.q.dtype == torch.int8 and w.q.device.type == device
        before = [k.launches for k in kernels]
        wgmma = int8_matmul.form_launches["wgmma"]
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
        want = (60, 10, 32) if device == "cuda" else (0, 0, 0)
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == want
        assert int8_matmul.form_launches["wgmma"] - wgmma == want[0]  # every path call
    assert np.isfinite(outs["cuda"]).all()
    diff = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert diff < 3e-4 * max(np.abs(outs["cpu"]).max(), 1.0), diff


@pytest.mark.parametrize("quant", [None, "int8"], ids=["dense", "int8"])
def test_htdemucs_6s_gpu_matches_cpu(gen, quant):
    """htdemucs-6s at full width (its transformer at C=384, 8 heads of
    D=48): K1 at D=48, K5 and, with int8 weights, K7 at K = 384 and 1536
    on the GPU against the plain twins on the CPU, within 3e-4 of the
    output's scale, with 10 K1, 32 K5 and (int8) 60 K7 launches for the
    one batch."""
    schema = TP.htdemucs_schema(HTDEMUCS_6S)
    sd = TP.from_state_dict(TP.init_flat(schema, seed=0), schema)
    if quant == "int8":
        sd = TP.quantize_int8(sd)
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    kernels = (flash_mha, dconv_sub_block, int8_matmul)
    for device in ("cuda", "cpu"):
        model = build_htdemucs(HTDEMUCS_6S, sd, device)
        before = [k.launches for k in kernels]
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
        want = (10, 32, 60 if quant else 0) if device == "cuda" else (0, 0, 0)
        assert tuple(k.launches - b for k, b in zip(kernels, before)) == want
    assert outs["cuda"].shape == (1, 6, 2, 32768) and np.isfinite(outs["cuda"]).all()
    diff = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert diff < 3e-4 * max(np.abs(outs["cpu"]).max(), 1.0), diff


# --- bit-reproducible training on the card ------------------------------------------

# a narrow htdemucs-4s whose transformer keeps K2/K3's head dim (512 / 8 = 64)
NARROW = dataclasses.replace(HTDEMUCS_4S, channels=8, t_layers=2)
NARROW_SEG = 8192


def _narrow_step(ema=0.9):
    schema = TP.htdemucs_schema(NARROW)
    model = build_htdemucs(NARROW, TP.from_state_dict(TP.init_flat(schema, seed=0), schema),
                           "cuda", train=True)
    return TrainStep(model, lr=1e-3, ema_decay=ema)


def _narrow_batches(n):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy((rng.standard_normal((2, 2, NARROW_SEG)) * 0.1)
                              .astype(np.float32)).cuda(),
             torch.from_numpy((rng.standard_normal((2, 4, 2, NARROW_SEG)) * 0.05)
                              .astype(np.float32)).cuda())
            for _ in range(n)]


def test_gpu_checkpoint_resume_is_exact(gen, tmp_path):
    """The counterpart of tests/test_torch_train.py's resume test on the
    card: 2 steps, save, load into a fresh model and optimizer, 2 more:
    bit-identical to 4 uninterrupted steps, the EMA included (K2, K3 and
    K5 run in every step)."""
    batches = _narrow_batches(4)
    before = flash_mha_bwd.launches
    ref = _narrow_step()
    for mix, refs in batches:
        ref(mix, refs)
    assert flash_mha_bwd.launches - before == 4 * 2 * NARROW.t_layers
    first = _narrow_step()
    for mix, refs in batches[:2]:
        first(mix, refs)
    save_train_state(tmp_path / "ckpt", first)
    resumed = _narrow_step()
    assert load_train_state(tmp_path / "ckpt", resumed) == 2
    for mix, refs in batches[2:]:
        resumed(mix, refs)
    for (name, a), (_, b) in zip(ref.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(a, b), name
    for name in ref.ema:
        assert torch.equal(ref.ema[name], resumed.ema[name]), name


# Two training steps with torch.use_deterministic_algorithms(True), which
# raises on any CUDA op of the step that has no deterministic form (and
# fills every torch.empty with NaN, so a workspace element that a kernel
# reads before writing would show in the loss); run in a process of its
# own, whose cuBLAS workspace is set as that mode asks.
_DETERMINISTIC_STEP = """
import sys
import torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
torch.use_deterministic_algorithms(True)
from test_torch_cuda import _narrow_batches, _narrow_step
step = _narrow_step()
for mix, refs in _narrow_batches(2):
    loss = step(mix, refs)
torch.cuda.synchronize()
assert torch.isfinite(loss), loss
print("ok", float(loss))
"""


def test_training_step_runs_under_deterministic_algorithms(gen):
    here = Path(__file__).resolve().parent
    code = _DETERMINISTIC_STEP.format(root=str(here.parent), tests=str(here))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok"), proc.stdout


# --- the host side of the track path on the card ------------------------------------


def _narrow_separator(device, **kw):
    schema = TP.htdemucs_schema(NARROW)
    model = build_htdemucs(NARROW, TP.from_state_dict(TP.init_flat(schema, seed=0), schema),
                           device)
    opts = ApplyOptions(segment_samples=NARROW_SEG, batch_size=2, shift_offset=7,
                        max_shift_secs=0.02, **kw)
    return Separator(model, 4, opts, device)


def _host_track(n=60000):
    # 60000 + 882 - 7 samples after the shift: 10 segments, 5 batches of 2
    return (np.random.default_rng(3).standard_normal((2, n)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_separation_is_bit_identical(gen, depth):
    """Up to `depth` batches in flight (pinned staging ring, stems copied
    on the side stream, the device output held for that stream by
    record_stream): bit-identical to depth 1, twice in a row, with K1's
    launches per segment batch unchanged."""
    track = _host_track()
    ref = _narrow_separator("cuda", pipeline_depth=1)(track)
    piped = _narrow_separator("cuda", pipeline_depth=depth)
    before = flash_mha.launches
    for _ in range(2):
        np.testing.assert_array_equal(piped(track), ref)
    assert flash_mha.launches - before == 2 * 5 * 2 * NARROW.t_layers
    assert len(piped._staging) == depth
    assert all(buf.is_pinned() for buf, _ in piped._staging)


def test_fused_and_int16_paths_on_the_card(gen):
    """The default path against the CPU (3e-4 of scale); the fused pass
    against it (1e-5 of scale; bit-identical on a rerun, one K1 call per
    group of 2 segments); int16 transfers, batched and fused, within the
    budget of tests/test_pipeline.py outside the clipped tail."""
    track = _host_track()
    ref = _narrow_separator("cuda")(track)
    cpu = _narrow_separator("cpu")(track)
    scale = max(np.abs(cpu).max(), 1.0)
    assert np.abs(ref - cpu).max() < 3e-4 * scale
    sep = _narrow_separator("cuda", fused_track=True)
    before = flash_mha.launches
    fused = sep(track)
    assert flash_mha.launches - before == 5 * 2 * NARROW.t_layers
    assert np.abs(fused - ref).max() <= 1e-5 * scale
    np.testing.assert_array_equal(sep(track), fused)
    std = track.mean(0).std(ddof=1)
    atol = 2.0 / PCM16_TRANSFER_SCALE * max(std, 1.0)
    for kw in (dict(transfer_int16=True), dict(fused_track=True, transfer_int16=True)):
        err = np.abs(_narrow_separator("cuda", **kw)(track) - ref)
        assert (err > atol).mean() < 0.02, kw
        assert err[np.abs(ref) < 7.5 * std].max() <= atol, kw


def test_stage_marks_time_the_device(gen):
    """fine_progress on the card: each mark is a CUDA event, emitted after
    its batch with its stage's device time, in the CPU run's sequence of
    (fraction, message); 23 marks per call of the 2-layer model."""
    track = _host_track(20000)
    runs = {}
    for device in ("cuda", "cpu"):
        progress = TimedProgress()
        _narrow_separator(device, fine_progress=True)(track, progress=progress)
        runs[device] = progress
    cuda, cpu = runs["cuda"], runs["cpu"]
    assert [e[1:] for e in cuda.events] == [e[1:] for e in cpu.events]
    timed = [d for d in cuda.device_s if d is not None]
    n_calls = sum(e[2].startswith("segments") for e in cuda.events)
    assert len(timed) == (4 * NARROW.depth + NARROW.t_layers + 5) * n_calls
    assert all(d >= 0 for d in timed) and sum(timed) > 0
    assert all(d is None for d in cpu.device_s)


# --- bf16 inference: the kernels' bf16 forms and the bf16 models --------------------

BF16 = torch.bfloat16


@pytest.mark.parametrize("N,C,h,T,dil", DCONV_SHAPES)
def test_dconv_sub_block_bf16_matches_plain(gen, f32, N, C, h, T, dil):
    """K5's bf16 form (bf16 in and out, f32 inside, the same plan as f32)
    against its twin (the f32 chain on the widened inputs, rounded once)
    at every DCONV_SHAPES case, within the bf16 tolerance."""
    x, ws = _dconv_operands(gen, N, C, h, T)
    x, ws = x.to(BF16), [w.to(BF16) for w in ws]
    before = dconv_sub_block.launches, dconv_sub_block.launches_by_dtype["bfloat16"]
    out = dconv_sub_block(x, *ws, dil)
    torch.cuda.synchronize()
    assert (dconv_sub_block.launches, dconv_sub_block.launches_by_dtype["bfloat16"]) == \
        (before[0] + 1, before[1] + 1)
    assert out.shape == x.shape and out.dtype == BF16
    assert _rel_err(out, dconv_sub_block_plain(x, *ws, dil)) <= TOL[BF16]
    assert torch.equal(out, dconv_sub_block(x, *ws, dil))


@pytest.mark.parametrize("R,C,T", [(1, 4, 37), (2, 768, 336), (2, 1536, 168), (3, 5, 1),
                                   (8, 768, 336), (8, 1536, 168), (1, 768, 336),
                                   (1, 1536, 168)])
def test_gn_glu_scale_res_bf16_matches_plain(gen, R, C, T):
    args = [a.to(BF16) for a in _tail_operands(gen, R, C, T)]
    before = gn_glu_scale_res.launches_by_dtype["bfloat16"]
    out = gn_glu_scale_res(*args)
    torch.cuda.synchronize()
    assert gn_glu_scale_res.launches_by_dtype["bfloat16"] == before + 1
    assert out.shape == args[-1].shape and out.dtype == BF16
    assert _rel_err(out, gn_glu_scale_res_plain(*args)) <= TOL[BF16]
    assert torch.equal(out, gn_glu_scale_res(*args))


@pytest.mark.parametrize("T,B,H", [(336, 1, 192), (336, 2, 192), (168, 2, 384),
                                   (168, 8, 384), (168, 9, 384), (37, 5, 16), (60, 3, 100),
                                   (40, 1, 512)])
def test_bilstm_recurrence_bf16_matches_plain(gen, T, B, H):
    """K6's bf16 form (w_hh's slice in bf16 in shared memory, gates and c
    in f32, h rounded to bf16 each step) against the twin of the same
    semantics; absolute tolerance, h lies in (-1, 1)."""
    xs, w_hh = (t.to(BF16) for t in _lstm_operands(gen, T, B, H))
    before = bilstm_recurrence.launches_by_dtype["bfloat16"]
    ys = bilstm_recurrence(xs, w_hh)
    torch.cuda.synchronize()
    assert bilstm_recurrence.launches_by_dtype["bfloat16"] == before + 1
    assert ys.shape == (T, 2, B, H) and ys.dtype == BF16
    err = (ys.float() - bilstm_recurrence_plain(xs, w_hh).float()).abs().max().item()
    assert err <= TOL[BF16], err
    assert torch.equal(ys, bilstm_recurrence(xs, w_hh))


@pytest.mark.parametrize("M,N,K,form", INT8_FORMS)
def test_int8_matmul_bf16_weight_mode_matches_plain(gen, f32, M, N, K, form):
    """K7's bf16-rounded-weight mode (the --bf16 --int8 path's) in each
    form against its twin, x @ bf16(bf16(q) bf16(s))^T + b in f32, at the
    f32 tolerance; the same bits on repeat."""
    x, q, scale, b = _int8_operands(gen, M, N, K)
    if form == "simt":
        plan = QuantPlan("simt", 128, 64, K % 4 == 0, M, N)
    else:
        plan = QuantPlan("wgmma", int(form[5:]), 128, False, M, N)
    before = int8_matmul.launches_by_dtype["bfloat16"]
    y = launch_plan(x, q, scale, b, plan, BF16)
    assert int8_matmul.launches_by_dtype["bfloat16"] == before + 1
    assert _rel_err(y, int8_matmul_plain(x, q, scale, b, BF16)) <= TOL[torch.float32]
    assert torch.equal(y, launch_plan(x, q, scale, b, plan, BF16))


def _bf16_gpu_and_cpu(cfg, schema, mode):
    """A full-width model with `mode` weights ("bf16": cast to bf16;
    "bf16_int8": int8 widened to bf16; "f32") on the GPU and the CPU, on
    one 32768-sample segment; {device: output} and the GPU's launches."""
    sd = TP.from_state_dict(TP.init_flat(schema, seed=0), schema)
    quant_dtype = torch.float32
    if mode == "bf16":
        sd = TP.cast_state_dict(sd, BF16)
    elif mode == "bf16_int8":
        sd, quant_dtype = TP.quantize_int8(sd), BF16
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs, launches = {}, {}
    kernels = (flash_mha, bilstm_recurrence, dconv_sub_block, gn_glu_scale_res, int8_matmul)
    for device in ("cuda", "cpu"):
        model = build_model(cfg, sd, device, quant_dtype=quant_dtype)
        before = [dict(k.launches_by_dtype) for k in kernels]
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(mix).to(device)).cpu().numpy()
        launches[device] = {k.__name__: {d: n - b[d] for d, n in k.launches_by_dtype.items()}
                            for k, b in zip(kernels, before)}
    return outs, launches["cuda"]


@pytest.mark.parametrize("family", ["htdemucs_4s", "hdemucs_mmi"])
def test_bf16_model_gpu_matches_cpu(gen, family):
    """--bf16 at full width: the bf16 kernels on the GPU against the plain
    twins on the CPU, no further apart (norms) than the two devices' f32
    results plus twice the CPU's own bf16 error against f32, and every
    kernel of the path launched in its bf16 form for the one batch. (The
    f32 term is hdemucs_mmi's: at these random weights its spectrum is
    mostly its mean, whose inverse FFT cancels to a residue, so cuFFT's
    and the CPU's f32 roundings differ by ~0.8% of the output's norm,
    more than bf16 adds.)"""
    cfg = HTDEMUCS_4S if family == "htdemucs_4s" else HDEMUCS_V3
    schema = (TP.htdemucs_schema if family == "htdemucs_4s" else TP.hdemucs_v3_schema)(cfg)
    outs, launches = _bf16_gpu_and_cpu(cfg, schema, "bf16")
    ref32, _ = _bf16_gpu_and_cpu(cfg, schema, "f32")
    assert np.isfinite(outs["cuda"]).all()
    norm = np.linalg.norm
    assert norm(outs["cuda"] - outs["cpu"]) <= (norm(ref32["cuda"] - ref32["cpu"])
                                                + 2 * norm(outs["cpu"] - ref32["cpu"]))
    assert np.linalg.norm(outs["cuda"] - ref32["cuda"]) < 0.08 * np.linalg.norm(ref32["cuda"])
    want = ({"flash_mha": 10, "dconv_sub_block": 32} if family == "htdemucs_4s" else
            {"bilstm_recurrence": 8, "dconv_sub_block": 16, "gn_glu_scale_res": 4})
    for name, per_dtype in launches.items():
        assert per_dtype == {"float32": 0, "bfloat16": want.get(name, 0)}, (name, per_dtype)


@pytest.mark.parametrize("family", ["htdemucs_4s", "hdemucs_mmi"])
def test_bf16_int8_model_gpu_matches_cpu(gen, family):
    """--bf16 --int8 at full width: an f32 network whose int8 linears run
    K7's bf16-rounded-weight mode, GPU against CPU within 3e-4 of the
    output's scale (as the f32 models)."""
    cfg = HTDEMUCS_4S if family == "htdemucs_4s" else HDEMUCS_V3
    schema = (TP.htdemucs_schema if family == "htdemucs_4s" else TP.hdemucs_v3_schema)(cfg)
    outs, launches = _bf16_gpu_and_cpu(cfg, schema, "bf16_int8")
    assert np.isfinite(outs["cuda"]).all()
    diff = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert diff < 3e-4 * max(np.abs(outs["cpu"]).max(), 1.0), diff
    assert launches["int8_matmul"] == {"float32": 0,
                                       "bfloat16": 60 if family == "htdemucs_4s" else 4}
    assert launches["dconv_sub_block"]["bfloat16"] == 0


# --- the fine-tuned bag and streaming on the card ------------------------------------

def _bag_state_dicts(cfg=HTDEMUCS_4S):
    """Four full-width htdemucs-4s state dicts, seeds 0-3."""
    schema = TP.htdemucs_schema(cfg)
    return [TP.from_state_dict(TP.init_flat(schema, seed=s), schema) for s in range(4)]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["dense", "int8"])
def test_bag_gpu_matches_cpu(gen, quant):
    """The bag of four full-width htdemucs-4s models on one segment: 40 K1
    and 128 K5 launches (10 and 32 per model) and, with int8 weights, 240
    K7, and no other kernel; GPU against CPU within 3e-4 of the output's
    scale; stem i equal to stem i of model i run alone."""
    sds = _bag_state_dicts()
    if quant == "int8":
        sds = [TP.quantize_int8(sd) for sd in sds]
    mix = (np.random.default_rng(42).standard_normal((1, 2, 32768)) * 0.1).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        bag = build_bag(HTDEMUCS_4S, sds, device)
        before = {k.__name__: k.launches for k in KERNELS}
        with torch.inference_mode():
            outs[device] = bag(torch.from_numpy(mix).to(device)).cpu().numpy()
        launched = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        want = {"flash_mha": 40, "dconv_sub_block": 128,
                "int8_matmul": 240 if quant else 0} if device == "cuda" else {}
        assert launched == {name: want.get(name, 0) for name in launched}, launched
    assert outs["cuda"].shape == (1, 4, 2, 32768) and np.isfinite(outs["cuda"]).all()
    diff = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert diff < 3e-4 * max(np.abs(outs["cpu"]).max(), 1.0), diff
    for i in (0, 3):
        with torch.inference_mode():
            alone = build_model(HTDEMUCS_4S, sds[i], "cuda")(torch.from_numpy(mix).cuda())
        np.testing.assert_array_equal(outs["cuda"][:, i], alone[:, i].cpu().numpy())


@pytest.mark.parametrize("family", ["htdemucs_4s", "hdemucs_mmi", "bag"])
def test_stream_on_the_gpu_matches_offline(gen, family):
    """StreamingSeparator on the card (1 s chunks, max_batch 2, the track's
    statistics) against the offline Separator without shift on the card,
    within 1e-5 of the output's scale; every device call runs the path's
    kernels."""
    if family == "bag":
        model, per_call = build_bag(HTDEMUCS_4S, _bag_state_dicts(), "cuda"), \
            {"flash_mha": 40, "dconv_sub_block": 128}
    else:
        cfg = HTDEMUCS_4S if family == "htdemucs_4s" else HDEMUCS_V3
        schema = (TP.htdemucs_schema if family == "htdemucs_4s" else TP.hdemucs_v3_schema)(cfg)
        model = build_model(cfg, TP.from_state_dict(TP.init_flat(schema, seed=0), schema),
                            "cuda")
        per_call = ({"flash_mha": 10, "dconv_sub_block": 32} if family == "htdemucs_4s"
                       else {"bilstm_recurrence": 8, "dconv_sub_block": 16,
                             "gn_glu_scale_res": 4})
    n = 12 * 44100
    track = (np.random.default_rng(9).standard_normal((2, n)) * 0.2).astype(np.float32)
    mono = track.mean(0)
    stream = StreamingSeparator(model, 4, stats=(float(mono.mean()), float(mono.std(ddof=1))),
                                max_batch=2)
    before = {k.__name__: k.launches for k in KERNELS}
    outs = [stream.push(track[:, pos:pos + 44100]) for pos in range(0, n, 44100)]
    outs.append(stream.flush())
    launched = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    got = np.concatenate([o for o in outs if o.shape[-1]], -1)
    offline = Separator(model, 4, ApplyOptions(batch_size=2, shift_offset=0,
                                               max_shift_secs=0.0))(track)
    assert got.shape == offline.shape == (4, 2, n) and np.isfinite(got).all()
    assert np.abs(got - offline).max() <= 1e-5 * max(np.abs(offline).max(), 1.0)
    # 12 s: the segment at 0 in one call of the pushes, the tails at 5.85 s
    # and 11.7 s in one call of the flush
    assert launched == {name: per_call.get(name, 0) * 2 for name in launched}, launched


# --- training through K6 and K4, and the training modes ------------------------------

def _function_gradients(fn, plain, inputs, cot):
    """fn(*inputs) and autograd through plain(*inputs): the outputs and
    every input's gradient against the cotangent `cot`."""
    def run(f):
        ts = [t.clone().requires_grad_() for t in inputs]
        out = f(*ts)
        (out.float() * cot).sum().backward()
        return out.detach(), [t.grad for t in ts]

    return run(fn), run(plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bilstm_function_gradients(gen, dtype):
    """ops.BiLSTMRecurrence on the card at v3's encoder-5 shape: K6 forward
    (one launch), the backward autograd through the recomputed twin,
    against autograd through the twin alone: the output within K6's
    absolute tolerance of the twin (h lies in (-1, 1)), the gradients those
    of the same autograd on the same inputs (1e-6 of the largest entry)."""
    from demucs_tpu_torch.ops import BiLSTMRecurrence

    xs, w_hh = _lstm_operands(gen, 168, 2, 384)
    xs, w_hh = xs.to(dtype), w_hh.to(dtype)
    cot = torch.randn(168, 2, 2, 384, device="cuda", generator=gen)
    before = bilstm_recurrence.launches
    with f32_precision():
        (out, grads), (ref, refs) = _function_gradients(BiLSTMRecurrence.apply,
                                                        bilstm_recurrence_plain, (xs, w_hh), cot)
    assert bilstm_recurrence.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and _rel_err(g, r) <= 1e-6, _rel_err(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gn_glu_scale_res_function_gradients(gen, dtype):
    """ops.GnGluScaleRes on the card at v3's encoder-5 tail: K4 forward, the
    twin's gradients (the backward is the twin's own autograd, so they agree
    to the rounding of the forward's inputs)."""
    from demucs_tpu_torch.ops import GnGluScaleRes

    C, T = 1536, 168
    inputs = [torch.randn(*s, device="cuda", generator=gen).to(dtype)
              for s in ((2, 2 * C, T), (2 * C,), (2 * C,), (C,), (2, C, T))]
    cot = torch.randn(2, C, T, device="cuda", generator=gen)
    before = gn_glu_scale_res.launches
    with f32_precision():
        (out, grads), (ref, refs) = _function_gradients(GnGluScaleRes.apply,
                                                        gn_glu_scale_res_plain, inputs, cot)
    assert gn_glu_scale_res.launches == before + 1
    assert _rel_err(out, ref) <= TOL[dtype]
    for g, r in zip(grads, refs):
        assert _rel_err(g, r) <= 1e-6, _rel_err(g, r)


V3_SEG = 8192


def _v3_state():
    schema = TP.hdemucs_v3_schema(HDEMUCS_V3)
    return TP.from_state_dict(TP.init_flat(schema, seed=0), schema)


def _training_step_gpu_matches_cpu(cfg, sd, seg: int, want: dict) -> None:
    """One training step of the full-width `cfg` from `sd` on `seg`
    samples, on the card and on the CPU: the kernels `want` says and no
    other; the loss within 1e-5 and every gradient within 1e-3 of its own
    norm of the CPU's (the GroupNorm-removed means of the DConv conv
    biases' gradients and LocalState's key-bias gradients, zero up to
    rounding, within 1e-5 of the largest entry), with references a
    random-sign gap of 0.1-0.5 away from the estimate (as chip_smoke.py's
    phase_reference_training)."""
    from demucs_tpu_torch.models import feeds_group_norm

    rng = np.random.default_rng(1)
    mix = (rng.standard_normal((1, 2, seg)) * 0.1).astype(np.float32)
    with torch.no_grad():
        est = build_model(cfg, sd, "cpu")(torch.from_numpy(mix)).numpy()
    refs = (est + np.sign(rng.standard_normal(est.shape))
            * (0.1 + 0.4 * rng.random(est.shape))).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        before = {k.__name__: k.launches for k in KERNELS}
        step = TrainStep(build_model(cfg, sd, device, train=True))
        loss = step(torch.from_numpy(mix).to(device), torch.from_numpy(refs).to(device))
        torch.cuda.synchronize()
        launched = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        if device == "cuda":
            assert launched == {k.__name__: want.get(k.__name__, 0) for k in KERNELS}
        out[device] = loss.item(), {n: p.grad.double().cpu()
                                    for n, p in step.model.named_parameters()}
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-5 * lc
    top = max(g.abs().max().item() for g in gc.values())
    for name, c in gc.items():
        g = gg[name]
        assert torch.isfinite(g).all(), name
        if name.endswith("4.key.bias"):
            assert max(g.abs().max(), c.abs().max()) <= 1e-5 * top, name
            continue
        if feeds_group_norm(name):
            assert abs(g.mean() - c.mean()) <= 1e-5 * top, name
            g, c = g - g.mean(), c - c.mean()
        assert (g - c).norm() <= 1e-3 * max(c.norm(), 1e-6 * top), name


def test_v3_training_step_gpu_matches_cpu(gen):
    """One hdemucs_mmi training step at full width on 8192 samples: 8 K6,
    16 K5 and 4 K4 launches, no other kernel; GPU against CPU as
    `_training_step_gpu_matches_cpu` holds it."""
    _training_step_gpu_matches_cpu(HDEMUCS_V3, _v3_state(), V3_SEG, dict(
        bilstm_recurrence=8, dconv_sub_block=16, gn_glu_scale_res=4))


def test_6s_training_step_gpu_matches_cpu(gen):
    """One htdemucs-6s training step at full width (C=384, attention at
    D=48) on 8192 samples: 10 K2, 10 K3 and 32 K5 launches, no other
    kernel; GPU against CPU at the v4 tolerances (loss 1e-5, gradients
    1e-3 of their norm)."""
    schema = TP.htdemucs_schema(HTDEMUCS_6S)
    sd = TP.from_state_dict(TP.init_flat(schema, seed=0), schema)
    _training_step_gpu_matches_cpu(HTDEMUCS_6S, sd, V3_SEG, dict(
        flash_mha_fwd=10, flash_mha_bwd=10, dconv_sub_block=32))


def _count(fn):
    before = {k.__name__: k.launches for k in KERNELS}
    result = fn()
    torch.cuda.synchronize()
    return result, {k.__name__: k.launches - before[k.__name__] for k in KERNELS}


@pytest.mark.parametrize("policy", ["dots", "none", "dots_nb"])
def test_remat_on_the_card(gen, policy):
    """A narrow htdemucs-4s step with --remat in each policy: bit for bit
    the step without remat (the same kernels on the same inputs, cuDNN
    deterministic), and the launches the policy implies: K5 twice per
    sub-block, K2 twice per attention call unless "dots" keeps its
    outputs, K3 once."""
    mix, refs = _narrow_batches(1)[0]
    plain, remat = _narrow_step(ema=None), _narrow_step(ema=None)
    remat.loss_options.update(remat=True, remat_policy=policy)
    loss0, n0 = _count(lambda: plain(mix, refs))
    loss1, n1 = _count(lambda: remat(mix, refs))
    assert torch.equal(loss0, loss1)
    for a, b in zip(plain.model.parameters(), remat.model.parameters()):
        assert torch.equal(a, b)
    attn, dconv = 2 * NARROW.t_layers, 2 * 2 * NARROW.depth * NARROW.dconv_depth
    assert n0["flash_mha_fwd"] == n0["flash_mha_bwd"] == attn and n0["dconv_sub_block"] == dconv
    assert n1 == dict(n0, flash_mha_fwd=attn * (1 if policy == "dots" else 2),
                      dconv_sub_block=2 * dconv)


def test_remat_with_bf16_compute_on_the_card(gen):
    """--remat none under bf16 compute: the backward recomputes each layer
    on the bf16 weights, so the step equals bf16 compute alone bit for
    bit, and every launch is in its bf16 form."""
    mix, refs = _narrow_batches(1)[0]
    plain, remat = _narrow_step(ema=None), _narrow_step(ema=None)
    plain.loss_options["compute_dtype"] = torch.bfloat16
    remat.loss_options.update(compute_dtype=torch.bfloat16, remat=True, remat_policy="none")
    f32_before = dconv_sub_block.launches_by_dtype["float32"]
    loss0, _ = _count(lambda: plain(mix, refs))
    loss1, n1 = _count(lambda: remat(mix, refs))
    assert torch.equal(loss0, loss1) and n1["dconv_sub_block"] > 0
    assert dconv_sub_block.launches_by_dtype["float32"] == f32_before
    for a, b in zip(plain.model.parameters(), remat.model.parameters()):
        assert torch.equal(a, b)


def test_bf16_compute_on_the_card(gen):
    """A narrow htdemucs-4s step and a full-width hdemucs_mmi step (8192
    samples) with bf16 compute: every kernel launch in its bf16 form,
    a finite loss, f32 gradients and Adam moments."""
    by_dtype = [k for k in KERNELS if hasattr(k, "launches_by_dtype")]
    mix, refs = _narrow_batches(1)[0]
    v3 = TrainStep(build_model(HDEMUCS_V3, _v3_state(), "cuda", train=True),
                   compute_dtype=torch.bfloat16)
    narrow = _narrow_step(ema=None)
    narrow.loss_options["compute_dtype"] = torch.bfloat16
    for step, m, r in ((narrow, mix, refs), (v3, mix[:1, :, :V3_SEG], refs[:1, ..., :V3_SEG])):
        f32_before = {k.__name__: k.launches_by_dtype["float32"] for k in by_dtype}
        loss, n = _count(lambda: step(m, r))
        assert torch.isfinite(loss) and sum(n.values()) > 0
        assert {k.__name__: k.launches_by_dtype["float32"] for k in by_dtype} == f32_before
        p = next(step.model.parameters())
        assert p.grad.dtype == torch.float32
        assert step.optimizer.state[p]["exp_avg"].dtype == torch.float32


def test_steps_per_call_on_the_card(gen):
    """TrainStep.steps on 3 stacked batches: bit for bit 3 single calls."""
    batches = _narrow_batches(3)
    multi, single = _narrow_step(), _narrow_step()
    losses = multi.steps(torch.stack([m for m, _ in batches]),
                         torch.stack([r for _, r in batches]))
    assert torch.equal(losses, torch.stack([single(m, r) for m, r in batches]))
    for a, b in zip(multi.model.parameters(), single.model.parameters()):
        assert torch.equal(a, b)


def test_v3_checkpoint_resume_is_exact(gen, tmp_path):
    """hdemucs_mmi at full width on 8192 samples: 1 step, save, load into a
    fresh model and optimizer, 1 more: bit for bit 2 uninterrupted steps,
    the EMA included (K6, K5 and K4 run in every step)."""
    sd = _v3_state()
    rng = np.random.default_rng(2)
    batches = [(torch.from_numpy((rng.standard_normal((1, 2, V3_SEG)) * 0.1)
                                 .astype(np.float32)).cuda(),
                torch.from_numpy((rng.standard_normal((1, 4, 2, V3_SEG)) * 0.05)
                                 .astype(np.float32)).cuda()) for _ in range(2)]

    def fresh():
        return TrainStep(build_model(HDEMUCS_V3, sd, "cuda", train=True), ema_decay=0.9)

    ref = fresh()
    for mix, refs in batches:
        ref(mix, refs)
    first = fresh()
    first(*batches[0])
    save_train_state(tmp_path / "ckpt", first)
    resumed = fresh()
    assert load_train_state(tmp_path / "ckpt", resumed) == 1
    resumed(*batches[1])
    for (name, a), b in zip(ref.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), name
    for name in ref.ema:
        assert torch.equal(ref.ema[name], resumed.ema[name]), name


def test_native_helpers_on_the_card_host(gen, tmp_path):
    """The native ggml parser and WAV codec build with g++ and load on the
    card's host, no caller falls back to numpy, and both agree with the
    numpy paths bit for bit."""
    from demucs_tpu_torch import audio, native
    from demucs_tpu_torch.params import ggml

    for name in ("ggml_loader", "wav_io"):
        assert native.load(name) is not None
    path = tmp_path / "m.bin"
    flat = {"a.w": np.random.default_rng(0).standard_normal((64, 48)).astype(np.float16),
            "b": np.arange(7, dtype=np.float16)}
    TP.write_ggml(path, "htdemucs_4s", flat)
    kind, tensors = ggml.load_ggml(path)
    assert kind == "htdemucs_4s"
    for name, arr in flat.items():
        assert tensors[name].tobytes() == arr.tobytes()
    x = (np.random.default_rng(1).standard_normal((2, 44100)) * 0.5).astype(np.float32)
    audio.write_wav(tmp_path / "a.wav", x, pcm16=True)
    a, b = audio.read_wav(tmp_path / "a.wav"), audio.read_wav(tmp_path / "a.wav", native=False)
    assert a[1] == b[1] and a[0].tobytes() == b[0].tobytes()
    assert not native.FALLBACK


def test_memory_report_int8_on_the_card(gen):
    """memory_report on the card: int8 weights under 0.3 of the f32 ones
    (the quantized bulk at a quarter), the same output, every allocator
    number positive, and the peak at least what was resident and the
    output."""
    from demucs_tpu_torch.tools.memory_report import compiled_memory

    f32, i8 = (compiled_memory("4s", batch=1, segment=32768, dtype=torch.float32, int8=q)
               for q in (False, True))
    assert i8["weight_bytes"] < 0.3 * f32["weight_bytes"]
    assert i8["output_bytes"] == f32["output_bytes"]
    for rep in (f32, i8):
        assert rep["temp_bytes"] > 0 and rep["resident_bytes"] >= rep["argument_bytes"]
        assert rep["peak_bytes"] >= rep["resident_bytes"] + rep["output_bytes"]

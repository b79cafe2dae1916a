"""The arithmetic of the tensor-core int8-dequant matmul (K7), and its
plan, on the CPU.

`csrc/quant_matmul.cu`'s "wgmma" form runs y = (x @ float(q)^T) * scale +
bias on Hopper's tensor cores as 2xTF32: an int8 value is exact in TF32,
so only x is split, hi = tf32(x) (as `cvt.rna.tf32.f32` rounds: to 10
mantissa bits, ties away from zero) and lo = tf32(x - hi), and each stage
of 32 k sums, per half stage, lo.q over two k-steps of 8, then hi.q, in a
fresh accumulator that is then added into a running f32 sum. The tensor core
truncates as it accumulates; this file models that as a rounding toward
zero after every k-step. A CUDA kernel cannot run here, so this file holds
a torch emulation of that arithmetic against the Pallas kernel of the JAX
package in interpret mode (`int8_matmul`) and against the port's plain
twin, shows that one TF32 pass misses the f32 tolerance, and that one
truncating accumulator over all of K drifts far further than the
kernel's 32-deep stages. It also checks the kernel's exact widening of
int8 to f32, and `quant_plan`, which picks the form and the tiles, at
every path shape of both families.

    python -m pytest -q tests/test_torch_quant_numerics.py   # ~10 s
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.pallas.quant_matmul import int8_matmul as pallas_int8_matmul

from demucs_tpu_torch.ops.cuda import int8_matmul_plain
from demucs_tpu_torch.ops.cuda.quant_matmul import (MAX_GRID_Y, ONE_CONSUMER_COST, SMS,
                                                    quant_plan)

from _torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5       # of max|reference|, as the card holds K7 to its twin
CHUNK = 32       # k per stage of the wgmma form, each in a fresh accumulator


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (ties away from zero), as f32: add half
    of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def stage_steps():
    """The k-steps of a 32-deep stage in the kernel's order, each the 8 k
    it sums: per half stage two k-steps; k-step kk holds k = 8t + 2kk and
    8t + 2kk + 1 for t = 0..3 (the kernel's k permutation, kq_chunk)."""
    return [[8 * t + 2 * kk + e for t in range(4) for e in range(2)] for kk in range(4)]


def emulate(x, q, scale, bias=None, form="2xtf32", fresh=True):
    """K7's wgmma form on x (M, K) f32 and q (N, K) int8 -> y (M, N) f32.

    Per stage of 32 k (zeros past K), per half stage: lo.q over its two
    k-steps, then hi.q; each k-step's exact sum is added to the stage's
    accumulator and truncated toward zero to f32, and the stage is then
    added to the running sum with one f32 rounding; the scale and bias
    come last. form "tf32": one pass of tf32(x).q instead. fresh=False:
    one truncating accumulator over all of K, in the same order."""
    M, K = x.shape
    pad = -K % CHUNK
    x = torch.nn.functional.pad(x.float(), (0, pad))
    qd = torch.nn.functional.pad(q.double(), (0, pad))
    hi = tf32(x)
    parts = (tf32(x - hi), hi) if form == "2xtf32" else (hi,)
    steps = stage_steps()
    acc = torch.zeros(M, q.shape[0])
    part = torch.zeros(M, q.shape[0])
    for k0 in range(0, K + pad, CHUNK):
        if fresh:
            part = torch.zeros(M, q.shape[0])
        for half in (steps[:2], steps[2:]):
            for a in parts:
                for ks in half:
                    ks = [k0 + k for k in ks]
                    part = trunc_f32(part.double() + a[:, ks].double() @ qd[:, ks].T)
        if fresh:
            acc = acc + part
    y = (acc if fresh else part) * scale.float()
    return y if bias is None else y + bias.float()


def _operands(M, N, K, seed, bf16=False):
    """x at unit scale (bf16-representable values if `bf16`), a weight at
    1/sqrt(K) quantized per output channel, a small bias; numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if bf16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    w = rng.standard_normal((N, K)).astype(np.float32) / np.sqrt(K)
    scale = np.maximum(np.abs(w).max(1) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return x, q, scale, (rng.standard_normal(N) * 0.01).astype(np.float32)


def _rel(ours, ref):
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    return ((ours - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("K", [512, 2048])
def test_2xtf32_matches_pallas(K):
    """The emulation against the Pallas kernel in interpret mode, which
    feeds its matrix unit bf16: x is drawn bf16-representable (so lo is 0
    and the cast exact), as tests/test_torch_quant.py does for the twin."""
    x, q, scale, _ = _operands(64, 48, K, seed=K, bf16=True)
    ref = pallas_int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                             interpret=True)
    ours = emulate(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    assert _rel(ours, ref) <= TOL, _rel(ours, ref)


@pytest.mark.parametrize("M,N,K", [(40, 56, 512), (24, 40, 2048), (37, 50, 48), (5, 3, 16)])
def test_2xtf32_matches_plain(M, N, K):
    """General f32 x against the port's plain twin, with a bias; the
    ragged K (48 = a stage and a half, 16) end in a partial stage."""
    x, q, scale, b = _operands(M, N, K, seed=M + N + K)
    ts = [torch.from_numpy(a) for a in (x, q, scale, b)]
    assert _rel(emulate(*ts), int8_matmul_plain(*ts)) <= TOL


def test_single_tf32_pass_misses_the_tolerance():
    """Why the split: one TF32 pass (10 mantissa bits of x) lands at least
    10x further from the twin than 2xTF32, and outside the tolerance."""
    x, q, scale, b = _operands(32, 32, 2048, seed=1)
    ts = [torch.from_numpy(a) for a in (x, q, scale, b)]
    ref = int8_matmul_plain(*ts)
    err = {form: _rel(emulate(*ts, form=form), ref) for form in ("2xtf32", "tf32")}
    assert err["2xtf32"] <= TOL, err
    assert err["tf32"] >= 10 * err["2xtf32"] and err["tf32"] > TOL, err


def test_one_truncating_accumulator_drifts_at_k2048():
    """Why a fresh accumulator per 32-deep stage: at K = 2048 one running
    wgmma accumulator takes 512 truncating k-steps (256 of each product)
    and lands at least 10x further from the exact product than the
    kernel's stages do, at a quarter of the tolerance or more (1.2e-5 of
    scale at this seed, against 3.3e-7). The model truncates by at most
    one ulp a k-step, gentler than the card (K1's first tensor-core form
    drifted 3e-5 of scale over 1008 k-steps of one accumulator)."""
    x, q, scale, _ = _operands(64, 64, 2048, seed=0)
    x, q, scale = (torch.from_numpy(a) for a in (x, q, scale))
    exact = (x.double() @ q.double().T) * scale.double()
    err = {fresh: ((emulate(x, q, scale, fresh=fresh).double() - exact).abs().max()
               / exact.abs().max()).item() for fresh in (True, False)}
    assert err[True] <= TOL / 10, err
    assert err[False] >= 10 * err[True] and err[False] >= TOL / 4, err


def test_int8_widening_is_exact():
    """The kernel widens int8 to f32 by placing b + 128 in the low
    mantissa bits of 2^23 and subtracting 2^23 + 128 (widen4): exact for
    all 256 values."""
    b = np.arange(-128, 128, dtype=np.int32)
    u = (b ^ 0x80) & 0xFF
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) - np.float32(8388736.0)
    assert f.dtype == np.float32 and np.array_equal(f, b.astype(np.float32))


# --- K7's plan ----------------------------------------------------------------

# the nn.Linear products of each family's --int8 path at batch B: (M, K, N);
# htdemucs: Q/K/V/output projections (C, C), linear1 (C -> 4C), linear2
# (4C -> C) over B x {2688 frequency, 1344 time} tokens, C = 512 (4s) or 384
# (6s); hdemucs_mmi: the BiLSTM output linears of encoder 4 (336 frames,
# 384 -> 192) and encoder 5 (168 frames, 768 -> 384)
def _path_shapes(family, B):
    if family == "hdemucs_mmi":
        return [(B * 336, 384, 192), (B * 168, 768, 384)]
    C = 512 if family == "htdemucs_4s" else 384
    return [(B * T, K, N) for T in (2688, 1344) for K, N in ((C, C), (C, 4 * C), (4 * C, C))]


@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("family", ["htdemucs_4s", "htdemucs_6s", "hdemucs_mmi"])
def test_quant_plan_takes_wgmma_at_every_path_shape(family, B):
    """Every path shape of every family takes the tensor cores, with tiles
    of 128 columns and 128 or 64 rows that cover y, a grid the card takes,
    and the tile height with the fewer rounds of 132 blocks (by the
    plan's cost)."""
    for M, K, N in _path_shapes(family, B):
        p = quant_plan(M, N, K, x_ptr=256, q_ptr=4096)
        what = (family, B, M, K, N, p)
        assert p.form == "wgmma" and p.cols == 128 and p.rows in (64, 128), what
        assert p.consumers == p.rows // 64 and p.threads == 128 * (p.consumers + 1), what
        gx, gy = p.grid
        assert (gx - 1) * p.cols < N <= gx * p.cols, what
        assert (gy - 1) * p.rows < M <= gy * p.rows and gy <= MAX_GRID_Y, what

        def cost(rows):
            blocks = -(-N // 128) * -(-M // rows)
            return -(-blocks // SMS) * (1.0 if rows == 128 else ONE_CONSUMER_COST)

        assert cost(p.rows) == min(cost(128), cost(64)), what
        if cost(128) <= cost(64):
            assert p.rows == 128, what


@pytest.mark.parametrize("M,N,K", [(70, 97, 48), (130, 65, 16), (257, 129, 80)])
def test_quant_plan_takes_wgmma_at_ragged_shapes(M, N, K):
    """K % 32 == 16 (the last stage half zeros), an odd N and a ragged M
    still take the tensor cores: 16-byte loads address every row."""
    p = quant_plan(M, N, K, x_ptr=0, q_ptr=0)
    assert p.form == "wgmma" and p.cols == 128 and p.rows in (64, 128), p
    assert p.grid == (-(-N // 128), -(-M // p.rows)), p


@pytest.mark.parametrize("M,N,K,x_ptr,q_ptr,vec", [
    (130, 70, 37, 0, 0, False), (1, 1, 1, 0, 0, False), (129, 65, 17, 0, 0, False),
    (257, 66, 20, 0, 0, True), (70, 96, 64, 4, 0, False), (64, 64, 64, 0, 8, True)])
def test_quant_plan_takes_simt_where_16_byte_rows_fail(M, N, K, x_ptr, q_ptr, vec):
    """K % 16 != 0, or x or q not 16-byte aligned: the CUDA-core form, in
    128 x 64 tiles, with 16-byte x loads only where K % 4 == 0 and x is
    aligned (q 4-byte aligned)."""
    p = quant_plan(M, N, K, x_ptr=x_ptr, q_ptr=q_ptr)
    assert (p.form, p.rows, p.cols, p.vec, p.consumers, p.threads) == (
        "simt", 128, 64, vec, 0, 256), p
    assert p.grid == (-(-N // 64), -(-M // 128))


def test_quant_plan_is_deterministic():
    """The same shape and alignment give the same plan; a 16-byte offset
    changes nothing."""
    assert quant_plan(5376, 512, 2048, 0, 0) == quant_plan(5376, 512, 2048, 16, 32)

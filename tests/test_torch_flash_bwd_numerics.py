"""The arithmetic of the tensor-core flash backward (K3), on the CPU.

`csrc/flash_mha_bwd.cu` runs the five products of the attention backward
on Hopper's tensor cores: f32 as 3xTF32 (lo.hi + hi.lo + hi.hi of operands
rounded as `cvt.rna.tf32.f32` rounds), bf16 natively with P rounded to
bf16 before dV and dS before dQ and dK. A CUDA kernel cannot run here, so
this file holds a torch emulation of that arithmetic in the kernel's
order: 64-key blocks, 32-row T tiles taken in turns by two consumers that
each keep a running dK and dV (added c0 + c1 at the end), P rebuilt in
the log2 domain, dS in f32, and each block's share of dQ summed over the
blocks in block order. It is held against the Pallas `flash_mha_bwd` of
the JAX package in interpret mode at lengths that end in partial tiles,
shows what a single TF32 pass would miss, and models the tensor core's
truncating accumulation at the training length, which is why dK and dV
can stay running accumulators.

The emulation is the test's own; the package's plain twin stays its only
plain version (one case at lengths the Pallas kernel refuses holds the
emulation against it).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.pallas.attention import flash_mha_bwd as jax_flash_mha_bwd
from demucs_tpu_torch.ops.cuda import flash_mha_bwd_plain, flash_mha_fwd_plain
from test_torch_flash_numerics import product, tf32

from _torch_threads import _one_torch_thread  # noqa: F401

KEYS, ROWS, CONSUMERS = 64, 32, 2  # as the kernel: keys per block, rows per T tile
TOL = {"f32": 1e-4, "bf16": 2e-2}  # of max|reference|, each gradient
LOG2E = math.log2(math.e)


def emulate(q, k, v, do, lse, delta, form: str):
    """The kernel's backward on f32 tensors q, do (BH, T, D), k, v (BH, S,
    D), lse, delta (BH, T): -> (dq, dk, dv), f32."""
    T, D = q.shape[1:]
    scale = 1.0 / math.sqrt(D)
    lse2 = lse * LOG2E
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for k0 in range(0, k.shape[1], KEYS):
        kb, vb = k[:, k0:k0 + KEYS], v[:, k0:k0 + KEYS]
        acc_k = [torch.zeros(kb.shape) for _ in range(CONSUMERS)]
        acc_v = [torch.zeros(vb.shape) for _ in range(CONSUMERS)]
        part = torch.zeros(q.shape)
        for i, t0 in enumerate(range(0, T, ROWS)):
            c, rows = i % CONSUMERS, slice(t0, t0 + ROWS)
            qt, dot = q[:, rows], do[:, rows]
            st = product(kb, qt, form)               # S^T (keys, rows)
            dpt = product(vb, dot, form)             # dP^T
            p = torch.exp2(st * (scale * LOG2E) - lse2[:, None, rows])
            ds = p * (dpt - delta[:, None, rows])    # dS^T in f32
            # (product rounds both operands to bf16 in the bf16 form: P and dS)
            acc_v[c] = acc_v[c] + product(p, dot.transpose(-1, -2), form)
            acc_k[c] = acc_k[c] + product(ds, qt.transpose(-1, -2), form)
            part[:, rows] = (product(kb.transpose(-1, -2), ds.transpose(-1, -2), form)
                             * scale).transpose(-1, -2)
        dq = dq + part                               # the blocks in order
        dk[:, k0:k0 + KEYS] = (acc_k[0] + acc_k[1]) * scale
        dv[:, k0:k0 + KEYS] = acc_v[0] + acc_v[1]
    return dq, dk, dv


def _inputs(T, S, D, seed, bf16=False):
    """q, k, v, do (1, 1, n, D) from numpy (bf16 values kept in f32 for the
    bf16 form), and the forward's o and lse from the plain twin."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 1, n, D)).astype(np.float32))
                   for n in (T, S, S, T))
    if bf16:
        q, k, v, do = (x.bfloat16().float() for x in (q, k, v, do))
    o, lse = flash_mha_fwd_plain(q, k, v)
    if bf16:
        o = o.bfloat16().float()
    return q, k, v, do, o, lse


def _emulate(q, k, v, do, o, lse, form):
    delta = (do * o).sum(-1)
    flat = [x.reshape(-1, *x.shape[2:]) for x in (q, k, v, do, lse, delta)]
    return emulate(*flat, form)


_PALLAS: dict = {}


def _pallas(q, k, v, do, o, lse, dtype=jnp.float32):
    """The Pallas backward in interpret mode (each input once per run) ->
    (dq, dk, dv) as f32 (BH, n, D)."""
    key = (tuple(q.shape), tuple(k.shape), float(q.sum()), str(dtype))
    if key not in _PALLAS:
        args = [jnp.asarray(x.numpy(), dtype) for x in (q, k, v, o)]
        lse3 = jnp.asarray(lse.reshape(-1, q.shape[2], 1).numpy())
        grads = jax_flash_mha_bwd(*args, lse3, jnp.asarray(do.numpy(), dtype), interpret=True)
        _PALLAS[key] = [torch.from_numpy(np.array(g, dtype=np.float32)).reshape(-1, *g.shape[2:])
                        for g in grads]
    return _PALLAS[key]


def _rel(ours, ref):
    return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(ours, ref))


@pytest.mark.parametrize("D", [48, 64])
@pytest.mark.parametrize("T,S", [(128, 96), (72, 136)])
def test_3xtf32_matches_pallas(D, T, S):
    """The f32 form against the Pallas kernel: dq, dk and dv each within
    1e-4 of its scale. 96 and 136 keys end in a partial 64-key block, 72
    rows in a partial 32-row tile, and 128 rows give each consumer two."""
    inputs = _inputs(T, S, D, seed=T + S + D)
    ours = _emulate(*inputs, "3xtf32")
    assert _rel(ours, _pallas(*inputs)) <= TOL["f32"]


@pytest.mark.parametrize("D", [48, 64])
def test_3xtf32_ragged_matches_plain(D):
    """Lengths the Pallas kernel refuses (70 rows: two tiles and 6 rows; 45
    keys: one partial block), against the port's plain twin."""
    q, k, v, do, o, lse = _inputs(70, 45, D, seed=D)
    ours = _emulate(q, k, v, do, o, lse, "3xtf32")
    ref = [g.reshape(-1, *g.shape[2:]) for g in flash_mha_bwd_plain(q, k, v, o, lse, do)]
    assert _rel(ours, ref) <= TOL["f32"]


def test_single_tf32_pass_misses_the_tolerance():
    """Why the split: one TF32 pass (10 mantissa bits per operand) lands
    outside K3's f32 tolerance and at least 10x further from the Pallas
    kernel than 3xTF32 (dS = P (dP - delta) cancels, so dP's error shows)."""
    inputs = _inputs(72, 136, 64, seed=72 + 136 + 64)  # a case of the first test
    ref = _pallas(*inputs)
    err = {form: _rel(_emulate(*inputs, form), ref) for form in ("3xtf32", "tf32")}
    assert err["3xtf32"] <= TOL["f32"], err
    assert err["tf32"] > TOL["f32"] and err["tf32"] >= 10 * err["3xtf32"], err


@pytest.mark.parametrize("D,T,S", [(64, 72, 136), (48, 128, 96)])
def test_bf16_form_matches_pallas(D, T, S):
    """The bf16 form (bf16 operands on the tensor cores, P rounded to bf16
    before dV and dS before dQ and dK, f32 accumulators) against the Pallas
    kernel on bf16 operands, which rounds p.astype(do.dtype) and
    ds.astype(k.dtype) too: within 2e-2 of scale, after rounding ours to
    bf16 as the kernel stores it."""
    inputs = _inputs(T, S, D, seed=3 * D + T, bf16=True)
    ours = [g.bfloat16().float() for g in _emulate(*inputs, "bf16")]
    assert _rel(ours, _pallas(*inputs, dtype=jnp.bfloat16)) <= TOL["bf16"]


def _trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def test_running_accumulators_hold_at_training_length():
    """dK and dV are running wgmma accumulators over a consumer's T tiles.
    The tensor core truncates as it accumulates: modelled here as a round
    toward zero after every k-step of 8 rows, for each of the three 3xTF32
    passes. At the training length T = 2688 (42 tiles of 32 rows per
    consumer) that leaves dK = dS^T Q at least 5x inside K3's 1e-4
    tolerance, though 10x or more further off than a fresh accumulator per
    tile would be (which would cost registers the kernel does not have)."""
    rng = np.random.default_rng(0)
    T, D = 2688, 64
    qd = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    # a dS^T-like A: mixed signs, magnitudes spread over e^-4 .. 1
    a = torch.from_numpy((rng.standard_normal((KEYS, T))
                          * np.exp(-4 * rng.random((KEYS, T)))).astype(np.float32))
    exact = a.double() @ qd.double()
    a_hi, q_hi = tf32(a), tf32(qd)
    a_lo, q_lo = tf32(a - a_hi), tf32(qd - q_hi)

    def tile(acc, t0):
        for x, y in ((a_lo, q_hi), (a_hi, q_lo), (a_hi, q_hi)):
            for k0 in range(t0, t0 + ROWS, 8):
                acc = _trunc_f32(acc.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double())
        return acc

    err = {}
    for fresh in (False, True):
        acc = [torch.zeros(KEYS, D) for _ in range(CONSUMERS)]
        for i, t0 in enumerate(range(0, T, ROWS)):
            c = i % CONSUMERS
            acc[c] = acc[c] + tile(torch.zeros(KEYS, D), t0) if fresh else tile(acc[c], t0)
        err[fresh] = ((acc[0] + acc[1]).double() - exact).abs().max().item() / exact.abs().max().item()
    assert err[False] <= TOL["f32"] / 5, err
    assert err[False] >= 10 * err[True], err

"""The arithmetic of the tensor-core flash forward (K1, K2), on the CPU.

`csrc/flash_mha.cu` runs both products of attention on Hopper's tensor
cores. Its f32 form is 3xTF32: each operand x becomes hi = tf32(x) (as
`cvt.rna.tf32.f32` rounds: to 10 mantissa bits, ties away from zero) and
lo = tf32(x - hi), and each product is lo.hi + hi.lo + hi.hi; its bf16 form
rounds P to bf16 before P.V. A CUDA kernel cannot run here, so this file
holds a torch emulation of that arithmetic (64-key tiles, the online
softmax in the log2 domain, each tile's P.V summed into the running
output with one rounding) against the Pallas kernels of the JAX package in
interpret mode (`flash_mha`, `flash_mha_fwd`: out and lse), and shows why
the split is there: a single TF32 pass misses the f32 tolerance by far.

The emulation is the test's own; the package's plain twins stay its only
plain versions (one ragged case holds the emulation against them). The
last test pins that a kernel library is rebuilt when the shared header
`csrc/sm90.cuh`, which `flash_mha.cu` includes, changes.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demucs_tpu.ops.pallas.attention import flash_mha as jax_flash_mha
from demucs_tpu.ops.pallas.attention import flash_mha_fwd as jax_flash_mha_fwd

from demucs_tpu_torch.ops.cuda import build, flash_mha_fwd_plain

from _torch_threads import _one_torch_thread  # noqa: F401

KEYS = 64                        # keys per tile, as the kernel
TOL = {"f32": 1e-5, "bf16": 1e-2}  # of max|reference|
TOL_LSE = 1e-5                   # of max|lse|, plus as much absolute


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (ties away from zero), as f32: add half
    of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, form: str) -> torch.Tensor:
    """a @ b^T in f32 as the tensor cores compute it in `form`: products of
    the rounded operands are exact, their sum is taken in f64 here."""
    def mm(x, y):
        return torch.matmul(x.double(), y.double().transpose(-1, -2))

    if form == "3xtf32":
        a_hi, b_hi = tf32(a), tf32(b)
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        out = mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)
    elif form == "tf32":
        out = mm(tf32(a), tf32(b))
    else:  # bf16: the operands are bf16 values already
        out = mm(a.bfloat16().float(), b.bfloat16().float())
    return out.float()


def emulate(q, k, v, form: str):
    """The kernel's forward on f32 tensors (BH, T, D), (BH, S, D):
    -> (out (BH, T, D), lse (BH, T)), f32."""
    D = q.shape[-1]
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for s0 in range(0, k.shape[1], KEYS):
        kt, vt = k[:, s0:s0 + KEYS], v[:, s0:s0 + KEYS]
        s = product(q, kt, form) * scale_log2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = product(p.bfloat16().float() if form == "bf16" else p,
                     vt.transpose(-1, -2), form)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / l[..., None], (m + torch.log2(l)) * math.log(2.0)


def _inputs(T, S, D, seed, bf16=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 2, n, D)).astype(np.float32) for n in (T, S, S))
    if bf16:  # values a bf16 tensor holds, kept in f32
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    return q, k, v


def _flat(x):
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(-1, *x.shape[2:])


def _rel(ours, ref):
    ref = torch.from_numpy(np.array(ref, dtype=np.float32)).reshape(ours.shape)
    return ((ours - ref).abs().max() / ref.abs().max()).item()


def _pallas(q, k, v, kernel: str, dtype=jnp.float32):
    """The Pallas kernel in interpret mode -> (out (BH, T, D), lse or None)."""
    args = (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype))
    if kernel == "K1":
        out, lse = jax_flash_mha(*args, interpret=True), None
    else:
        out, lse = jax_flash_mha_fwd(*args, interpret=True)
        lse = torch.from_numpy(np.array(lse)).reshape(-1, q.shape[2])
    return torch.from_numpy(np.array(out, dtype=np.float32)).reshape(-1, *q.shape[2:]), lse


def _lse_ok(ours, ref):
    return (ours - ref).abs().max().item() <= TOL_LSE * ref.abs().max().item() + TOL_LSE


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("D", [48, 64])
@pytest.mark.parametrize("T,S", [(72, 136), (136, 72)])
def test_3xtf32_matches_pallas(kernel, D, T, S):
    """The f32 form against the Pallas kernel: out within 1e-5 of scale,
    K2's lse within 1e-5 of max|lse| + 1e-5. Both key lengths end in a
    partial 64-key tile (136 = 2 x 64 + 8, 72 = 64 + 8)."""
    q, k, v = _inputs(T, S, D, seed=T + S + D)
    out, lse = emulate(_flat(q), _flat(k), _flat(v), "3xtf32")
    ref, ref_lse = _pallas(q, k, v, kernel)
    assert _rel(out, ref) <= TOL["f32"], _rel(out, ref)
    if kernel == "K2":
        assert _lse_ok(lse, ref_lse)


@pytest.mark.parametrize("D", [48, 64])
@pytest.mark.parametrize("T,S", [(70, 45), (3, 129)])
def test_3xtf32_ragged_matches_plain(D, T, S):
    """Lengths the Pallas kernel refuses (no multiple-of-8 divisor), against
    the port's plain twin: the last key tile is partial."""
    q, k, v = _inputs(T, S, D, seed=7 * D + S)
    out, lse = emulate(_flat(q), _flat(k), _flat(v), "3xtf32")
    ref, ref_lse = flash_mha_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    assert _rel(out, ref.reshape(out.shape)) <= TOL["f32"]
    assert _lse_ok(lse, ref_lse.reshape(lse.shape))


@pytest.mark.parametrize("D", [48, 64])
def test_single_tf32_pass_is_10x_further_than_3xtf32(D):
    """Why the split: one TF32 pass (10 mantissa bits) lands at least 10x
    further from the Pallas kernel than 3xTF32, and outside the f32
    tolerance the kernel is held to."""
    q, k, v = _inputs(136, 136, D, seed=D)
    ref, _ = _pallas(q, k, v, "K1")
    err = {form: _rel(emulate(_flat(q), _flat(k), _flat(v), form)[0], ref)
           for form in ("3xtf32", "tf32")}
    assert err["3xtf32"] <= TOL["f32"], err
    assert err["tf32"] >= 10 * err["3xtf32"] and err["tf32"] > TOL["f32"], err


@pytest.mark.parametrize("D", [48, 64])
def test_bf16_form_matches_pallas(D):
    """The bf16 form (operands bf16 on the tensor cores, P rounded to bf16
    before P.V, f32 statistics) against the Pallas kernel on bf16 operands,
    which rounds p.astype(v.dtype) too: within 1e-2 of scale, lse within
    1e-5 of max|lse| + 1e-5 (f32 on both sides, from the same operands)."""
    q, k, v = _inputs(72, 136, D, seed=11 * D, bf16=True)
    out, lse = emulate(_flat(q), _flat(k), _flat(v), "bf16")
    ref, ref_lse = _pallas(q, k, v, "K2", jnp.bfloat16)
    assert _rel(out.bfloat16().float(), ref) <= TOL["bf16"]
    assert _lse_ok(lse, ref_lse)


def test_library_is_stale_after_a_shared_header_changes(tmp_path, monkeypatch):
    """build._stale: a library older than its own source or than any
    csrc/*.cuh is rebuilt (a source may include any header)."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    (csrc / "k.cu").write_text("")
    (csrc / "h.cuh").write_text("")
    assert build._stale("k")  # not built yet
    lib = build.library_path("k")
    lib.write_text("")
    for path, t in ((csrc / "k.cu", 100), (csrc / "h.cuh", 100), (lib, 200)):
        os.utime(path, (t, t))
    assert not build._stale("k")
    os.utime(csrc / "h.cuh", (300, 300))
    assert build._stale("k")

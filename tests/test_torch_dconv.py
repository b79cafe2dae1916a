"""The fused DConv kernels' plain twins (K5 `dconv_sub_block_plain`, K4
`gn_glu_scale_res_plain`) and the autograd Function `ops.DConvSubBlock`
against demucs_tpu on the CPU.

Each twin is held against the Pallas kernel it stands for, run in
interpret mode, and against the JAX model code it computes
(`models/htdemucs.py:dconv` and `dconv_tail`); the Function's gradients
(with the twin as its forward, as on the CPU) against `jax.grad` of
`dconv`. Inputs come from numpy seeds. The kernels themselves run only
on the card: tests/test_torch_cuda.py holds them against these twins.
K5's plan (`dconv_plan`, which picks its form and cuts its work) is
checked here at every path shape, without a card.

    python -m pytest -q tests/test_torch_dconv.py     # ~20 s on one worker
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import ops as JO
from demucs_tpu.models.htdemucs import dconv as jax_dconv
from demucs_tpu.models.htdemucs import dconv_tail as jax_dconv_tail
from demucs_tpu.ops.pallas.dconv import dconv_sub_block as pallas_dconv_sub_block
from demucs_tpu.ops.pallas.norms import gn_glu_scale_res as pallas_gn_glu_scale_res

from demucs_tpu_torch import ops as TO
from demucs_tpu_torch.models.htdemucs import DConv
from demucs_tpu_torch.ops.cuda import (dconv_sub_block, dconv_sub_block_plain,
                                       gn_glu_scale_res, gn_glu_scale_res_plain)
from demucs_tpu_torch.ops.cuda.dconv import SMEM_LIMIT, dconv_plan

from _torch_threads import _one_torch_thread  # noqa: F401

# the Pallas K5 takes two-pass statistics and a polynomial erf (|err| <=
# 1.5e-7): 1e-5 of the output's scale; the JAX graph the same maths in
# another order of sums: 1e-6
TOL_PALLAS, TOL_JAX = 1e-5, 1e-6
# gradients: a GroupNorm's backward subtracts means, so each gradient is
# held to 1e-5 of its own scale plus 1e-5 of the largest entry of all
TOL_GRAD = 1e-5
NAMES = ("w0", "b0", "g1", "be1", "w3", "b3", "g4", "be4", "scale")


def _rand(rng, *shape, scale=1.0, offset=0.0):
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def _block(seed: int, C: int, h: int) -> dict[str, np.ndarray]:
    """One sub-block's weights at the scale of a trained layer's."""
    rng = np.random.default_rng(seed)
    return dict(w0=_rand(rng, h, C, 3, scale=0.3), b0=_rand(rng, h, scale=0.2),
                g1=_rand(rng, h, scale=0.2, offset=1.0), be1=_rand(rng, h, scale=0.2),
                w3=_rand(rng, 2 * C, h, 1, scale=0.3), b3=_rand(rng, 2 * C, scale=0.2),
                g4=_rand(rng, 2 * C, scale=0.2, offset=1.0), be4=_rand(rng, 2 * C, scale=0.2),
                scale=_rand(rng, C, scale=0.1))


def _jax_block(w: dict) -> dict:
    """The block in `models/htdemucs.py:dconv`'s parameter tree."""
    j = {k: jnp.asarray(v) for k, v in w.items()}
    return {"0": {"weight": j["w0"], "bias": j["b0"]},
            "1": {"weight": j["g1"], "bias": j["be1"]},
            "3": {"weight": j["w3"], "bias": j["b3"]},
            "4": {"weight": j["g4"], "bias": j["be4"]},
            "6": {"scale": j["scale"]}}


def _torch(w: dict) -> list[torch.Tensor]:
    return [torch.from_numpy(w[k]) for k in NAMES]


def _load(blk, ws: list[torch.Tensor]) -> None:
    """Copy one sub-block's weights into a `DConv` layer."""
    with torch.no_grad():
        for param, value in zip((blk[0].weight, blk[0].bias, blk[1].weight, blk[1].bias,
                                 blk[3].weight, blk[3].bias, blk[4].weight, blk[4].bias,
                                 blk[6].scale), ws):
            param.copy_(value)


def _x(seed, N, C, T):
    return _rand(np.random.default_rng(seed), N, C, T, scale=0.5, offset=0.1)


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


# (N, C, h, T, dil): a ragged T, N = 1, and T below the halo's 2 dil + 1
SHAPES = [(3, 16, 2, 37, 1), (1, 16, 4, 50, 2), (2, 8, 2, 4, 2), (1, 8, 3, 1, 1)]


@pytest.mark.parametrize("N,C,h,T,dil", SHAPES)
def test_sub_block_plain_matches_pallas(N, C, h, T, dil):
    x, w = _x(1, N, C, T), _block(2, C, h)
    ours = dconv_sub_block_plain(torch.from_numpy(x), *_torch(w), dil).numpy()
    ref = pallas_dconv_sub_block(jnp.asarray(x), *(jnp.asarray(w[k]) for k in NAMES),
                                 dil=dil, interpret=True)
    _close(ours, ref, TOL_PALLAS)


@pytest.mark.parametrize("N,C,h,T", [(3, 16, 2, 37), (1, 12, 3, 4), (2, 48, 6, 70)])
def test_sub_blocks_plain_match_model_dconv(N, C, h, T):
    """Two sub-blocks (dilations 1 and 2) of the twin against the JAX
    model's `dconv`, and the port's `DConv` module against both."""
    x, blocks = _x(3, N, C, T), [_block(4, C, h), _block(5, C, h)]
    ref = np.asarray(jax.jit(jax_dconv)(jnp.asarray(x), [_jax_block(w) for w in blocks]))
    ours = torch.from_numpy(x)
    for j, w in enumerate(blocks):
        ours = dconv_sub_block_plain(ours, *_torch(w), 2 ** j)
    _close(ours.numpy(), ref, TOL_JAX)
    module = DConv(C, C // h, 2)
    for blk, w in zip(module.layers, blocks):
        _load(blk, _torch(w))
    with torch.no_grad():
        assert torch.equal(module(torch.from_numpy(x)), ours)


@pytest.mark.parametrize("R,C,T", [(3, 8, 37), (1, 48, 336), (2, 4, 1)])
def test_gn_glu_scale_res_plain_matches_pallas_and_tail(R, C, T):
    rng = np.random.default_rng(6)
    x, res = _rand(rng, R, 2 * C, T, offset=0.3), _rand(rng, R, C, T)
    wt, bias = _rand(rng, 2 * C, scale=0.2, offset=1.0), _rand(rng, 2 * C, scale=0.2)
    scale = _rand(rng, C, scale=0.1)
    ours = gn_glu_scale_res_plain(*(torch.from_numpy(a) for a in (x, wt, bias, scale, res)))
    pallas = pallas_gn_glu_scale_res(*(jnp.asarray(a) for a in (x, wt, bias, scale, res)),
                                     interpret=True)
    _close(ours.numpy(), pallas, TOL_PALLAS)
    tail = jax_dconv_tail(jnp.asarray(x), {"weight": jnp.asarray(wt), "bias": jnp.asarray(bias)},
                          {"scale": jnp.asarray(scale)}, jnp.asarray(res))
    _close(ours.numpy(), tail, TOL_JAX)
    # the unfused JAX chain, which the tail is
    chain = res + JO.layer_scale(JO.glu(JO.group_norm(jnp.asarray(x), wt, bias, 1), 1), scale)
    _close(ours.numpy(), chain, TOL_JAX)


def test_wrappers_on_cpu_tensors_run_the_twins():
    """For CPU tensors the wrappers are the plain twins (bit for bit) and
    launch nothing; ops.dconv_sub_block is the twin too; a device that is
    neither CPU nor CUDA is refused."""
    N, C, h, T = 2, 8, 2, 21
    x, ws = torch.from_numpy(_x(7, N, C, T)), _torch(_block(8, C, h))
    before = (dconv_sub_block.launches, gn_glu_scale_res.launches)
    out = dconv_sub_block(x, *ws, 2)
    assert torch.equal(out, dconv_sub_block_plain(x, *ws, 2))
    blk = DConv(C, C // h, 2).layers[1]
    _load(blk, ws)
    with torch.no_grad():
        assert torch.equal(TO.dconv_sub_block(x, blk, 2), out)
    y, res = torch.randn(N, 2 * C, T), torch.randn(N, C, T)
    tail = gn_glu_scale_res(y, ws[6], ws[7], ws[8], res)
    assert torch.equal(tail, gn_glu_scale_res_plain(y, ws[6], ws[7], ws[8], res))
    assert (dconv_sub_block.launches, gn_glu_scale_res.launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dconv_sub_block(x.to("meta"), *(w.to("meta") for w in ws), 1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gn_glu_scale_res(y.to("meta"), ws[6], ws[7], ws[8], res)


@pytest.mark.parametrize("N,C,h,T", [(2, 16, 2, 37), (1, 8, 4, 5)])
def test_function_gradients_match_jax_grad(N, C, h, T):
    """Two sub-blocks (dilations 1 and 2) through `ops.DConvSubBlock` on
    the CPU (its forward the plain twin, its backward autograd through the
    recomputed twin): the loss sum(out * cot) and the gradients of x and of
    every weight against jax.grad of `models/htdemucs.py:dconv`."""
    x, blocks = _x(9, N, C, T), [_block(10, C, h), _block(11, C, h)]
    cot = _rand(np.random.default_rng(12), N, C, T)

    def jax_loss(x, tree):
        return jnp.sum(jax_dconv(x, tree) * cot)

    tree = [_jax_block(w) for w in blocks]
    jloss, (jgx, jgtree) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(x), tree)

    tx = torch.from_numpy(x).requires_grad_()
    tws = [[t.requires_grad_() for t in _torch(w)] for w in blocks]
    out = tx
    for j, ws in enumerate(tws):
        out = TO.DConvSubBlock.apply(out, *ws, 2 ** j)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    keys = (("0", "weight"), ("0", "bias"), ("1", "weight"), ("1", "bias"), ("3", "weight"),
            ("3", "bias"), ("4", "weight"), ("4", "bias"), ("6", "scale"))
    pairs = [("x", tx.grad, jgx)]
    for j, ws in enumerate(tws):
        pairs += [(f"{j}.{name}", t.grad, jgtree[j][a][b])
                  for name, t, (a, b) in zip(NAMES, ws, keys)]
    top = max(np.abs(np.asarray(ref)).max() for _, _, ref in pairs)
    for name, ours, ref in pairs:
        assert ours is not None, name
        ref = np.asarray(ref)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= TOL_GRAD * (np.abs(ref).max() + top), (name, err, np.abs(ref).max())


def test_function_without_grad_is_its_forward():
    """Under no_grad the Function builds no graph and returns the twin's
    result on the CPU."""
    N, C, h, T = 1, 8, 2, 9
    x, ws = torch.from_numpy(_x(13, N, C, T)), [t.requires_grad_() for t in
                                                 _torch(_block(14, C, h))]
    with torch.no_grad():
        out = TO.DConvSubBlock.apply(x, *ws, 1)
        ref = dconv_sub_block_plain(x, *ws, 1)
    assert out.grad_fn is None and torch.equal(out, ref)


# K5's plan at every DConv shape of both families' paths: the frequency
# levels fold B x {512, 128, 32, 8} rows of 336 frames, the time levels are
# one row per segment of {85995, 21499, 5375, 1344} samples; channels 48 x
# 2^level, hidden C/8 (htdemucs) or C/4 (hdemucs_mmi)
FREQ_ROWS, FREQ_T, TIME_T = (512, 128, 32, 8), 336, (85995, 21499, 5375, 1344)
# clusters of cs blocks an H100 SXM runs at once, as cudaOccupancyMaxActiveClusters
# gives them (ops/cuda/dconv.py:card_capacity): with one block per SM, and with two
H100_CLUSTERS = {1: (132, 264), 2: (66, 132), 3: (39, 79), 4: (30, 62), 5: (22, 47),
                 6: (17, 39), 7: (15, 32), 8: (15, 30)}


def h100_capacity(cs, threads, smem):
    return H100_CLUSTERS[cs][int(threads == 256 and smem <= SMEM_LIMIT // 2)]


def _path_shapes(B, comp):
    for lvl, rows in enumerate(FREQ_ROWS):
        yield B * rows, 48 << lvl, (48 << lvl) // comp, FREQ_T
    for lvl, T in enumerate(TIME_T):
        yield B, 48 << lvl, (48 << lvl) // comp, T


@pytest.mark.parametrize("capacity", [None, h100_capacity], ids=["model", "h100"])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("comp", [8, 4], ids=["htdemucs", "hdemucs_mmi"])
def test_dconv_plan_covers_every_path_shape(comp, B, capacity):
    """Shared bytes within a block's 227 KB, clusters of at most 16
    blocks, grid y within 65535, every column and output row in exactly
    one block, and one launch for every frequency row."""
    kw = {} if capacity is None else {"capacity": capacity}
    for N, C, h, T in _path_shapes(B, comp):
        for dil in (1, 2):
            p = dconv_plan(N, C, h, T, dil, **kw)
            what = (N, C, h, T, dil, p)
            assert all(0 < b <= SMEM_LIMIT for b in p.smem), what
            assert 1 <= p.cluster <= 16 and p.threads in (256, 512), what
            assert all(1 <= y <= 65535 and 1 <= x < 2 ** 31 for x, y in p.grids), what
            # columns: blocks of `cols` (a multiple of 4) tile [0, T), none empty
            assert p.cols % 4 == 0 and (p.blocks - 1) * p.cols < T <= p.blocks * p.cols, what
            # output rows: splits of rows0 (rows3) tile [0, h) ([0, 2C)), none
            # empty, staged in chunks of at most their size
            assert (p.splits0 - 1) * p.rows0 < h <= p.splits0 * p.rows0, what
            assert (p.splits3 - 1) * p.rows3 < 2 * C <= p.splits3 * p.rows3, what
            assert 1 <= p.chunk0 <= p.rows0 and 2 <= p.chunk3 <= p.rows3, what
            assert p.chunk3 % 2 == 0 and p.rows3 % 2 == 0, what  # whole GLU pairs
            if p.form == "tiles":
                assert p.launches == 3 and p.cluster == 1, what
                assert p.grids[0] == (p.blocks * p.splits0, N), what
                assert p.grids[2] == (p.blocks * p.splits3, N), what
                assert p.grids[1] == (p.blocks * (1 if p.gram else p.splits3), N), what
            else:
                assert p.launches == 1 and p.splits0 == p.splits3 == 1, what
                assert p.grids == ((p.blocks, N),) and p.cluster == p.blocks, what
                assert p.form == ("row" if p.blocks == 1 else "cluster"), what
            if T == FREQ_T:
                assert p.launches == 1, what
            if p.gram:
                assert -(-h // 4) * 4 <= 24 and 4 * h <= p.cols, what


def test_dconv_plan_refuses_what_no_form_runs():
    with pytest.raises(ValueError, match="out of range"):
        dconv_plan(0, 48, 6, 336)
    with pytest.raises(ValueError, match="no form"):
        dconv_plan(1, 20000, 6, 336)

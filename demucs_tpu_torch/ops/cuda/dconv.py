"""The fused DConv kernels: their wrappers (K5, K4) and their plain twins.

Two kernels, both in `csrc/dconv.cu`, each replacing a Pallas TPU kernel:

  * `dconv_sub_block` (K5) replaces `demucs_tpu/ops/pallas/dconv.py:
    dconv_sub_block` (`_sub_block_kernel`): one whole DConv sub-block on
    every row of x (N, C, T), conv (k=3, dilation d) C -> h, GroupNorm(1),
    GELU, 1x1 conv h -> 2C, GroupNorm(1), GLU, LayerScale and the
    residual. It runs on every DConv sub-block of htdemucs (32 per
    segment batch) and of hdemucs_mmi's encoders 0-3 (16), through
    `ops.dconv.dconv_sub_block`;
  * `gn_glu_scale_res` (K4) replaces `demucs_tpu/ops/pallas/norms.py:
    gn_glu_scale_res` (`_gn_glu_res_kernel`): GroupNorm(1) of x (R, 2C,
    T), GLU over channels, LayerScale and + res (R, C, T). It runs on
    the tail of hdemucs_mmi's encoder-4/5 DConv sub-blocks (4 per segment
    batch), where a BiLSTM and LocalState sit between the convolutions.

What bounds them on an H100: K4 the bytes; K5 the bytes at the narrow
levels (h <= 12) and the f32 operations at the wide ones. A row's
GroupNorm statistics span the whole row. K5 takes three forms, which
`dconv_plan` picks from the shape: a frequency row (T = 336) stays in one
block's shared memory ("row") or in a thread-block cluster's ("cluster")
from its load to its store, one launch; a time row, too long for any of
that, is cut into tiles over three launches that pass per-tile partial
sums through device memory ("tiles"). K4 is two launches of the latter
kind. The source says more; `PERF.md` has the times.

Both take f32 or bf16 tensors (all of one dtype), as the TPU kernels
do: in bf16 they read bf16 and write bf16, and every value in between
(shared memory, workspaces, statistics) is f32, so the result is the f32
function rounded once. Their plain twins do the same in bf16: the chain
in f32 on the widened inputs, rounded once (not the unfused chain in
bf16, which rounds between its ops).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain twin for CPU tensors; it never falls back. Both are bound as
custom ops, `torch.ops.demucs_tpu_torch.dconv_sub_block` and
`.gn_glu_scale_res`. `launches` counts the calls run on the kernel,
`launches_by_dtype` those of each dtype.
Both raise on CUDA inputs that require grad under grad mode (the kernels
write through raw pointers, which would drop the gradient): training
differentiates K5 through `ops.dconv.DConvSubBlock` and K4 through
`ops.dconv.GnGluScaleRes`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from ..conv import conv1d
from ..norms import gelu, glu, group_norm, layer_scale

SOURCE = "dconv"
SOURCES = (SOURCE,)
CHUNK = 2048   # K4 elements per block (csrc/dconv.cu kChunk)

# K5's blocks (csrc/dconv.cu): 256 threads, or 512 for a row or cluster
# block that fills an SM's shared memory alone; a warp's tile is 6 y rows
# (8 z rows) by 64 columns, 6 x 2 (8 x 2) outputs a thread; at most 8
# blocks per row (a portable cluster); 227 KB of shared memory per block;
# 132 SMs on an H100
THREADS, MAX_THREADS = 256, 512
TM0, TM3, TN = 6, 8, 2
WARP_COLS = 32 * TN
MAX_CLUSTER = 8
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472  # an SM's shared memory for its blocks (228 KB)
SMS = 132
RED = 48       # floats of reduction scratch (2 a warp) and cluster slots
TILE_COLS = (256, 128, 64, 32)  # the tiles form's widths, widest first
ROW, TILES = 0, 1  # csrc/dconv.cu kRowForm, kTileForm
MAX_GRAM = 24  # hp at most for z's sums from the Gram matrix (csrc/dconv.cu kMaxGram)


# --- plain twins ----------------------------------------------------------

def _in_f32(plain, ts, *args):
    """`plain` on f32 copies of `ts`, rounded once to their dtype: a twin's
    bf16 form (an f32 call runs as it is)."""
    if ts[0].dtype == torch.float32:
        return plain(*ts, *args)
    return plain(*(t.float() for t in ts), *args).to(ts[0].dtype)


def gn_glu_scale_res_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) -> GLU -> LayerScale -> + res, the chain of
    `models/htdemucs.py:dconv_tail`: x (R, 2C, T), res (R, C, T); in f32
    for bf16 inputs, rounded once."""
    if x.dtype != torch.float32:
        return _in_f32(gn_glu_scale_res_plain, (x, weight, bias, scale, res))
    y = group_norm(x, weight, bias, 1)
    y = glu(y, 1)
    y = layer_scale(y, scale)
    return res + y


def dconv_sub_block_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                          g1: torch.Tensor, be1: torch.Tensor, w3: torch.Tensor,
                          b3: torch.Tensor, g4: torch.Tensor, be4: torch.Tensor,
                          scale: torch.Tensor, dil: int) -> torch.Tensor:
    """One DConv sub-block as the chain of ops the models ran unfused:
    x (N, C, T), w0 (h, C, 3), w3 (2C, h, 1) -> (N, C, T); in f32 for
    bf16 inputs, rounded once."""
    if x.dtype != torch.float32:
        return _in_f32(dconv_sub_block_plain, (x, w0, b0, g1, be1, w3, b3, g4, be4, scale), dil)
    y = conv1d(x, w0, b0, padding=dil, dilation=dil)
    y = group_norm(y, g1, be1, 1)
    y = gelu(y)
    y = conv1d(y, w3, b3)
    return gn_glu_scale_res_plain(y, g4, be4, scale, x)


# --- K5's plan ------------------------------------------------------------

@dataclass(frozen=True)
class DConvPlan:
    """How one K5 call cuts its work; `dconv_plan` makes it and
    csrc/dconv.cu's check_plan refuses one it cannot run.

    form: "row" (a block per row), "cluster" (a row over a cluster of
    `blocks` blocks) or "tiles" (three launches over tiles). cols: columns
    per block (a slice of a row, or a tile); blocks: blocks per row (the
    cluster's size, or the tiles). splits0/rows0/chunk0: blocks that share
    a tile's y rows, y rows per block, rows of w0 staged at once; the
    same for z's 2C rows and w3 (splits3/rows3/chunk3). gram: z's sums
    come from the Gram matrix of w3, not from a pass of z. threads: per
    block. resident: w0 and w3 staged whole, side by side, at the start
    (the row forms). smem: dynamic shared bytes of each launch; N: rows."""

    form: str
    cols: int
    blocks: int
    splits0: int
    rows0: int
    chunk0: int
    splits3: int
    rows3: int
    chunk3: int
    gram: bool
    threads: int
    resident: bool
    smem: tuple[int, ...]
    N: int

    @property
    def cluster(self) -> int:
        """Blocks per cluster (1: none)."""
        return 1 if self.form == "tiles" else self.blocks

    @property
    def grids(self) -> tuple[tuple[int, int], ...]:
        """(x, y) of each launch: the row forms' one, or the tiles' (a),
        (b) and (c)."""
        if self.form != "tiles":
            return ((self.blocks, self.N),)
        return ((self.blocks * self.splits0, self.N),
                (self.blocks * (1 if self.gram else self.splits3), self.N),
                (self.blocks * self.splits3, self.N))

    @property
    def launches(self) -> int:
        return len(self.grids)

    def args(self) -> tuple[int, ...]:
        """The plan's ints as dconv_sub_block_f32 takes them."""
        smem = (*self.smem, 0, 0)[:3]
        return (ROW if self.form != "tiles" else TILES, self.cols, self.splits0, self.rows0,
                self.chunk0, self.splits3, self.rows3, self.chunk3, int(self.gram), self.threads,
                int(self.resident), *smem)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _largest(total: int, step: int, fits) -> int:
    """`total`, or else the largest multiple of `step` below it, for which
    fits(n) holds; 0 if none does."""
    if fits(total):
        return total
    n = (total - 1) // step * step
    while n >= step and not fits(n):
        n -= step
    return max(n, 0)


def model_capacity(cs: int, threads: int, smem: int) -> int:
    """Clusters of cs row-form blocks that run at once if the SMs packed
    perfectly: the model used without a card (the card packs fewer; see
    `card_capacity`)."""
    per_sm = min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 2)
    return max(SMS * per_sm // cs, 1)


@functools.lru_cache(maxsize=None)
def card_capacity(cs: int, threads: int, smem: int) -> int:
    """Clusters of cs row-form blocks that the current card runs at once
    (cudaOccupancyMaxActiveClusters: a cluster must fit in one GPC, so
    fewer than perfect packing gives)."""
    fn = build.load(SOURCE).dconv_cluster_capacity
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(torch.cuda.current_device()):
        n = fn(cs, threads, smem)
    if n < 0:
        raise RuntimeError(f"dconv_cluster_capacity failed: CUDA error {-n}")
    return max(n, 1)


@functools.lru_cache(maxsize=256)
def dconv_plan(N: int, C: int, h: int, T: int, dil: int = 1,
               capacity=model_capacity) -> DConvPlan:
    """K5's plan for x (N, C, T), h hidden channels and dilation dil
    (`capacity(cs, threads, smem)`: how many clusters run at once).

    A row whose slice fits one block's shared memory when split over at
    most 8 blocks runs in one launch: "row" over one block, or "cluster"
    over cs of them: the least cs whose slice fits beside the whole
    weights, or else (the weights staged in chunks: the wide levels) the
    cs whose waves (N rows over the clusters that run at once) times
    64-column warp tiles per block are fewest, the smaller at a tie: there
    a block's time follows its warp tiles, and a last wave costs a whole
    one. A block that fills an SM's shared memory alone takes 512
    threads. Otherwise "tiles": the widest tile whose passes leave room
    for two blocks per SM (else the widest that fits), and y's and z's
    rows split over more blocks while the grid is short of a wave (z's
    while every warp still has a tile of its own). z's sums come from the Gram
    matrix of w3 where h is small (h <= 24) beside the block's columns (4 h
    <= cols), so that the matrix costs a block less than the pass of z it
    saves. Weights are staged whole where they fit beside the rest (both
    at once in the row forms where both fit), else in the largest chunks
    of 6 (w0) or 8 (w3) rows that do. Raises ValueError for a shape no
    form can run."""
    if not (1 <= N <= 65535 and C >= 1 and h >= 1 and T >= 1 and 1 <= dil <= 1024):
        raise ValueError(f"dconv_sub_block: N={N} (1..65535), C={C}, h={h}, T={T}, "
                         f"dil={dil} (1..1024) out of range")
    Cp, hp, P = _up(C, 4), _up(h, 4), _up(dil, 4)
    K0, C2 = 3 * Cp, 2 * C
    vec = _up(3 * hp + 6 * C + Cp, 4)
    gram_floats = _up(hp * hp + 2 * hp + 2, 4)
    budget = SMEM_LIMIT // 4  # floats

    def x_floats(cols):
        return Cp * (_up(cols, 4) + 2 * P)

    def g_floats(cols):
        return hp * _up(cols, 4)

    def scratch(threads):
        return threads * TM0 * TN  # conv0's shared partial sums

    def row_floats(cols, chunk0, chunk3, gram=False, threads=THREADS, resident=False):
        w = chunk0 * K0 + chunk3 * hp if resident else max(chunk0 * K0, chunk3 * hp)
        return (x_floats(cols) + g_floats(cols) + w + vec + RED + scratch(threads)
                + (gram_floats if gram else 0))

    def conv0_floats(cols, chunk0):
        return x_floats(cols) + chunk0 * K0 + vec + RED + scratch(THREADS)

    def zstats_floats(cols, chunk3, gram):
        return g_floats(cols) + vec + RED + (C2 * hp + gram_floats if gram else chunk3 * hp)

    def apply_floats(cols, chunk3, rows3):
        return g_floats(cols) + chunk3 * hp + vec + RED + rows3 // 2 * _up(cols, 4)

    def use_gram(cols):
        return hp <= MAX_GRAM and 4 * h <= cols

    least0, least3 = min(h, TM0), min(C2, TM3)

    def row_plan(cs):
        """The row form over cs blocks, or None if a slice does not fit."""
        cols = _up(-(-T // cs), 4)
        if row_floats(cols, least0, least3) > budget:
            return None
        blocks = -(-T // cols)
        threads = THREADS
        if (row_floats(cols, least0, least3) > budget // 2
                and row_floats(cols, least0, least3, threads=MAX_THREADS) <= budget):
            threads = MAX_THREADS
        gram = use_gram(cols) and row_floats(cols, least0, C2, True, threads) <= budget
        resident = row_floats(cols, h, C2, gram, threads, True) <= budget
        chunk0 = h if resident else _largest(
            h, TM0, lambda n: row_floats(cols, n, C2 if gram else least3, gram, threads)
            <= budget)
        chunk3 = C2 if gram or resident else _largest(
            C2, TM3, lambda n: row_floats(cols, chunk0, n, False, threads) <= budget)
        smem = 4 * row_floats(cols, chunk0, chunk3, gram, threads, resident)
        return DConvPlan("row" if blocks == 1 else "cluster", cols, blocks, 1, h, chunk0,
                         1, C2, chunk3, gram, threads, resident, (smem,), N)

    # (a slice width that rounds to fewer blocks repeats a smaller cs)
    plans = [p for cs, p in enumerate(map(row_plan, range(1, MAX_CLUSTER + 1)), 1)
             if p is not None and p.blocks == cs]
    if plans:
        if plans[0].chunk0 == h and plans[0].chunk3 == C2:
            return plans[0]  # the weights fit whole beside the least slice

        def cost(p):
            waves = -(-N // capacity(p.blocks, p.threads, p.smem[0]))
            return waves * -(-p.cols // WARP_COLS), p.blocks

        return min(plans, key=cost)

    def fits(cols, limit):
        return (conv0_floats(cols, least0) <= limit and apply_floats(cols, least3, C2) <= limit
                and zstats_floats(cols, least3, use_gram(cols)) <= limit)

    cols = next((c for c in TILE_COLS[:-1] if fits(c, budget // 2)), None) \
        or next((c for c in TILE_COLS if fits(c, budget)), None)
    if cols is None:
        raise ValueError(f"dconv_sub_block: no form of K5 fits C={C}, h={h}, dil={dil} "
                         "in one block's shared memory")
    tiles = -(-T // cols)
    groups = -(-min(cols, T) // WARP_COLS)

    def split(total, step, least):
        """(splits, rows per block) for `total` rows: more blocks while the
        grid is short of a wave and each keeps `least` warp tiles."""
        splits, rows = 1, total
        while N * tiles * splits < SMS:
            nxt = _up(-(-total // (2 * splits)), step)
            if -(-nxt // step) * groups < least or nxt >= rows:
                break
            splits, rows = -(-total // nxt), nxt
        return splits, rows

    # conv0's warps share a tile's channels where a block has fewer tiles
    # than warps; z's do not
    splits0, rows0 = split(h, TM0, 1)
    splits3, rows3 = split(C2, TM3, THREADS // 32)
    gram = use_gram(cols)
    chunk0 = _largest(rows0, TM0, lambda n: conv0_floats(cols, n) <= budget)
    chunk3 = _largest(rows3, TM3, lambda n: apply_floats(cols, n, rows3) <= budget)
    return DConvPlan("tiles", cols, tiles, splits0, rows0, chunk0, splits3, rows3, chunk3, gram,
                     THREADS, False, (4 * conv0_floats(cols, chunk0),
                                      4 * zstats_floats(cols, chunk3, gram),
                                      4 * apply_floats(cols, chunk3, rows3)), N)


# --- kernels ----------------------------------------------------------------

def _check(name: str, named: dict[str, torch.Tensor],
           shapes: dict[str, tuple[int, ...]]) -> None:
    device = next(iter(named.values())).device
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise RuntimeError(
            f"{name} writes its CUDA result through raw pointers, which would drop "
            "the gradient; differentiate through ops.dconv.DConvSubBlock or "
            "GnGluScaleRes (or call this under torch.no_grad())")
    for tname, t in named.items():
        if t.device != device:
            raise ValueError(f"{name}: {tname} on {t.device}, x on {device}")
        if t.dtype != next(iter(named.values())).dtype or t.dtype not in build.DTYPE_SUFFIX:
            raise ValueError(f"{name} takes f32 or bf16 tensors of one dtype, got "
                             f"{tname} {t.dtype}")
        if tuple(t.shape) != shapes[tname]:
            raise ValueError(f"{name}: want {tname} {shapes[tname]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def dconv_sub_block(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    g1: torch.Tensor, be1: torch.Tensor, w3: torch.Tensor,
                    b3: torch.Tensor, g4: torch.Tensor, be4: torch.Tensor,
                    scale: torch.Tensor, dil: int) -> torch.Tensor:
    """K5. x (N, C, T), w0 (h, C, 3), b0, g1, be1 (h,), w3 (2C, h, 1), b3,
    g4, be4 (2C,), scale (C,), all f32 or all bf16 -> (N, C, T) in their
    dtype, a new tensor. The plan and the shared memory are the same in
    either dtype (the kernel's shared rows are f32)."""
    return build.call_op("dconv_sub_block", _dconv_sub_block_op,
                         x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil)


def _dconv_sub_block_cuda(x, w0, b0, g1, be1, w3, b3, g4, be4, scale, dil):
    ts = (x, w0, b0, g1, be1, w3, b3, g4, be4, scale)
    if x.ndim != 3 or w0.ndim != 3:
        raise ValueError(f"dconv_sub_block: want x (N, C, T) and w0 (h, C, 3), got "
                         f"{tuple(x.shape)}, {tuple(w0.shape)}")
    N, C, T = x.shape
    h = w0.shape[0]
    _check("dconv_sub_block",
           dict(x=x, w0=w0, b0=b0, g1=g1, be1=be1, w3=w3, b3=b3, g4=g4, be4=be4,
                scale=scale),
           dict(x=(N, C, T), w0=(h, C, 3), b0=(h,), g1=(h,), be1=(h,), w3=(2 * C, h, 1),
                b3=(2 * C,), g4=(2 * C,), be4=(2 * C,), scale=(C,)))
    plan = dconv_plan(N, C, h, T, dil, capacity=card_capacity)
    work = (None,) * 3  # y, part1, part2: only the tiles form has them
    if plan.form == "tiles":
        # one f32 allocation: y (N, h, T), then the two sets of partial sums
        sizes = (N * h * T, 2 * N * plan.grids[0][0], 2 * N * plan.grids[1][0])
        buf = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
        base = buf.data_ptr()
        work = (base, base + 4 * sizes[0], base + 4 * (sizes[0] + sizes[1]))
    out = torch.empty_like(x)
    fn = build.entry_point(SOURCE, f"dconv_sub_block_{build.DTYPE_SUFFIX[x.dtype]}", 14, 19)
    build.launch("dconv_sub_block", fn, x.device,
                 *(t.data_ptr() for t in ts), *work, out.data_ptr(), N, C, h, T, dil,
                 *plan.args())
    dconv_sub_block.launches += 1
    dconv_sub_block.launches_by_dtype[str(x.dtype)[6:]] += 1
    return out


def gn_glu_scale_res(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """K4. x (R, 2C, T), weight, bias (2C,), scale (C,), res (R, C, T), all
    f32 or all bf16 -> (R, C, T) in their dtype, a new tensor (the
    partial sums' workspace is f32)."""
    return build.call_op("gn_glu_scale_res", _gn_glu_scale_res_op, x, weight, bias, scale,
                         res)


def _gn_glu_scale_res_cuda(x, weight, bias, scale, res):
    ts = (x, weight, bias, scale, res)
    if x.ndim != 3 or x.shape[1] % 2:
        raise ValueError(f"gn_glu_scale_res: want x (R, 2C, T), got {tuple(x.shape)}")
    R, C2, T = x.shape
    C = C2 // 2
    _check("gn_glu_scale_res", dict(x=x, weight=weight, bias=bias, scale=scale, res=res),
           dict(x=(R, C2, T), weight=(C2,), bias=(C2,), scale=(C,), res=(R, C, T)))
    if not (1 <= R <= 65535 and C >= 1 and T >= 1 and C2 * T < 2 ** 31):
        raise ValueError(f"gn_glu_scale_res: R={R} (1..65535), C={C}, T={T} out of range")
    part = torch.empty(R, -(-C2 * T // CHUNK), 2, device=x.device, dtype=torch.float32)
    out = torch.empty_like(res)
    fn = build.entry_point(SOURCE, f"gn_glu_scale_res_{build.DTYPE_SUFFIX[x.dtype]}", 7, 3)
    build.launch("gn_glu_scale_res", fn, x.device,
                 *(t.data_ptr() for t in ts), part.data_ptr(), out.data_ptr(), R, C, T)
    gn_glu_scale_res.launches += 1
    gn_glu_scale_res.launches_by_dtype[str(x.dtype)[6:]] += 1
    return out


_dconv_sub_block_op = build.define_op(
    "dconv_sub_block",
    "(Tensor x, Tensor w0, Tensor b0, Tensor g1, Tensor be1, Tensor w3, Tensor b3, "
    "Tensor g4, Tensor be4, Tensor scale, int dil) -> Tensor",
    _dconv_sub_block_cuda, dconv_sub_block_plain,
    lambda x, *rest: x.new_empty(x.shape))
_gn_glu_scale_res_op = build.define_op(
    "gn_glu_scale_res",
    "(Tensor x, Tensor weight, Tensor bias, Tensor scale, Tensor res) -> Tensor",
    _gn_glu_scale_res_cuda, gn_glu_scale_res_plain,
    lambda x, weight, bias, scale, res: res.new_empty(res.shape))

dconv_sub_block.launches = 0
dconv_sub_block.launches_by_dtype = {"float32": 0, "bfloat16": 0}
gn_glu_scale_res.launches = 0
gn_glu_scale_res.launches_by_dtype = {"float32": 0, "bfloat16": 0}

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
levels and the f32 operations at the wide ones. A row's GroupNorm
statistics span more than a block can hold, so each kernel is several
launches that pass per-tile partial sums through device memory: K5
three (conv0; GroupNorm1, GELU and the statistics of z; the apply), K4
two. The source says more; `PERF.md` has the times.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain twin for CPU tensors; it never falls back. `launches` counts
the calls run on the kernel. Both take f32 only and raise on CUDA inputs
that require grad under grad mode (the kernels write through raw
pointers, which would drop the gradient): training differentiates K5
through `ops.dconv.DConvSubBlock`, and K4's caller, v3, is not trained.
"""

from __future__ import annotations

import torch

from . import build
from ..conv import conv1d
from ..norms import gelu, glu, group_norm, layer_scale

SOURCE = "dconv"
SOURCES = (SOURCE,)
TILE = 32      # K5 columns per block (csrc/dconv.cu kTile)
CHUNK = 2048   # K4 elements per block (csrc/dconv.cu kChunk)
MAX_HIDDEN = 384  # K5's (h, TILE) tile of GELU(y) in 48 KB of shared memory


# --- plain twins ----------------------------------------------------------

def gn_glu_scale_res_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) -> GLU -> LayerScale -> + res, the chain of
    `models/htdemucs.py:dconv_tail`: x (R, 2C, T), res (R, C, T)."""
    y = group_norm(x, weight, bias, 1)
    y = glu(y, 1)
    y = layer_scale(y, scale)
    return res + y


def dconv_sub_block_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                          g1: torch.Tensor, be1: torch.Tensor, w3: torch.Tensor,
                          b3: torch.Tensor, g4: torch.Tensor, be4: torch.Tensor,
                          scale: torch.Tensor, dil: int) -> torch.Tensor:
    """One DConv sub-block as the chain of ops the models ran unfused:
    x (N, C, T), w0 (h, C, 3), w3 (2C, h, 1) -> (N, C, T)."""
    y = conv1d(x, w0, b0, padding=dil, dilation=dil)
    y = group_norm(y, g1, be1, 1)
    y = gelu(y)
    y = conv1d(y, w3, b3)
    return gn_glu_scale_res_plain(y, g4, be4, scale, x)


# --- kernels ----------------------------------------------------------------

def _check(name: str, named: dict[str, torch.Tensor],
           shapes: dict[str, tuple[int, ...]]) -> None:
    device = next(iter(named.values())).device
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise RuntimeError(
            f"{name} writes its CUDA result through raw pointers, which would drop "
            "the gradient; differentiate through ops.dconv.DConvSubBlock (or call "
            "this under torch.no_grad())")
    for tname, t in named.items():
        if t.device != device:
            raise ValueError(f"{name}: {tname} on {t.device}, x on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes f32 only, got {tname} {t.dtype}")
        if tuple(t.shape) != shapes[tname]:
            raise ValueError(f"{name}: want {tname} {shapes[tname]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def dconv_sub_block(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    g1: torch.Tensor, be1: torch.Tensor, w3: torch.Tensor,
                    b3: torch.Tensor, g4: torch.Tensor, be4: torch.Tensor,
                    scale: torch.Tensor, dil: int) -> torch.Tensor:
    """K5. x (N, C, T), w0 (h, C, 3), b0, g1, be1 (h,), w3 (2C, h, 1), b3,
    g4, be4 (2C,), scale (C,), all f32 -> (N, C, T), a new tensor."""
    ts = (x, w0, b0, g1, be1, w3, b3, g4, be4, scale)
    if build.on_cpu("dconv_sub_block", *ts):
        return dconv_sub_block_plain(*ts, dil)
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
    if not (1 <= N <= 65535 and C >= 1 and T >= 1 and 1 <= h <= MAX_HIDDEN and dil >= 1):
        raise ValueError(f"dconv_sub_block: N={N} (1..65535), C={C}, T={T}, "
                         f"h={h} (1..{MAX_HIDDEN}), dil={dil} out of range")
    tiles = -(-T // TILE)
    y = torch.empty(N, h, T, device=x.device, dtype=torch.float32)
    part = torch.empty(2, N, tiles, 2, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    fn = build.entry_point(SOURCE, "dconv_sub_block_f32", 14, 5)
    build.launch("dconv_sub_block", fn, x.device,
                 *(t.data_ptr() for t in ts), y.data_ptr(), part[0].data_ptr(),
                 part[1].data_ptr(), out.data_ptr(), N, C, h, T, dil)
    dconv_sub_block.launches += 1
    return out


def gn_glu_scale_res(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """K4. x (R, 2C, T), weight, bias (2C,), scale (C,), res (R, C, T), all
    f32 -> (R, C, T), a new tensor."""
    ts = (x, weight, bias, scale, res)
    if build.on_cpu("gn_glu_scale_res", *ts):
        return gn_glu_scale_res_plain(*ts)
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
    fn = build.entry_point(SOURCE, "gn_glu_scale_res_f32", 7, 3)
    build.launch("gn_glu_scale_res", fn, x.device,
                 *(t.data_ptr() for t in ts), part.data_ptr(), out.data_ptr(), R, C, T)
    gn_glu_scale_res.launches += 1
    return out


dconv_sub_block.launches = 0
gn_glu_scale_res.launches = 0

"""The int8-dequant matmul: the CUDA kernel's wrapper (K7), its plan and
its plain twin.

`int8_matmul` (K7, `csrc/quant_matmul.cu`) replaces the Pallas TPU
kernel `demucs_tpu/ops/pallas/quant_matmul.py:int8_matmul` (`_kernel`):
y = (x @ float(q)^T) * scale + bias for x (M, K) f32 and a weight held
as int8 q (N, K) with an f32 scale per output channel, in nn.Linear
layout. The weight is widened inside the kernel, the sum is f32 and the
scale comes after it. Its second mode, `weight_dtype=torch.bfloat16`,
is the `--bf16 --int8` path's: there the JAX package widens each weight
as bf16(bf16(q) * bf16(scale)) before an f32 product, so the kernel forms
that weight where it widens q (every bf16 value is exact in TF32) and
applies no scale after the sum. On the `--int8` path it runs every nn.Linear-layout
product of a quantized weight, through `ops.attention.linear`: the Q, K,
V and output projections and both feed-forward linears of every
htdemucs transformer layer (60 per segment batch for htdemucs-4s), and
the BiLSTM output linear of hdemucs_mmi's encoder-4/5 sub-blocks (4).

What bounds it on an H100: at the Demucs shapes the operations. Two
forms, which `quant_plan` picks from the shape and the operands'
alignment: "wgmma" runs the product on the tensor cores as 2xTF32 (x
split into hi and lo, int8 exact in TF32) where 16-byte loads address
every row (K % 16 == 0, x and q 16-byte aligned: every path shape);
"simt", a register-blocked SGEMM on the CUDA cores, takes the rest. The
source says more; `PERF.md` has the times.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain twin for CPU tensors, as the custom op
`torch.ops.demucs_tpu_torch.int8_matmul`; it never falls back, from the
CUDA kernel to the twin or from one form to the other. It takes f32 x, scale and bias
and int8 q, and it raises on CUDA inputs that require grad under grad
mode: the kernel writes through raw pointers, which would drop the
gradient, and quantized weights are for inference. `launches` counts the
kernel launches, `form_launches` the launches of each form,
`launches_by_dtype` those of each weight mode (the dtype the weight is
widened to).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import build

SOURCE = "quant_matmul"
SOURCES = (SOURCE,)
SMS = 132         # SMs of an H100 SXM
MAX_GRID_Y = 65535
# the "wgmma" form (csrc/quant_matmul.cu): 128 columns of y per block, 64
# rows per consumer warpgroup, one or two consumers
TC_COLS = 128
TC_ROWS = (128, 64)
# time of a one-consumer block (64 rows) over a two-consumer one's (128
# rows), both alone on an SM: one consumer leaves the tensor cores idle
# while it waits for its products and adds them up. 0.61-0.69, mean 0.66,
# on an H100 at the v4 path shapes of B = 2 and 8 long enough for the
# device, not the host, to set the time (chip_smoke.py's K7 phase times
# both tile heights)
ONE_CONSUMER_COST = 0.66
# the "simt" form: 128 x 64 tiles of y (csrc/quant_matmul.cu BM, BN)
SIMT_ROWS, SIMT_COLS = 128, 64
# the weight modes (csrc/quant_matmul.cu kScaled, kBf16Weight): the dtype
# the weight is widened to
_MODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class QuantPlan:
    """How one K7 call cuts its work; `quant_plan` makes it.

    form: "wgmma" (tensor cores, 2xTF32) or "simt" (CUDA cores); rows,
    cols: the tile of y per block; vec: the simt form reads x 16 and q 4
    bytes at a time."""

    form: str
    rows: int
    cols: int
    vec: bool
    M: int
    N: int

    @property
    def consumers(self) -> int:
        """Consumer warpgroups per block of the wgmma form (0 for simt)."""
        return self.rows // 64 if self.form == "wgmma" else 0

    @property
    def grid(self) -> tuple[int, int]:
        return -(-self.N // self.cols), -(-self.M // self.rows)

    @property
    def threads(self) -> int:
        return 128 * (self.consumers + 1) if self.form == "wgmma" else 256


@functools.lru_cache(maxsize=256)
def _plan(M: int, N: int, K: int, x_align: int, q_align: int) -> QuantPlan:
    if K % 16 == 0 and x_align % 16 == 0 and q_align % 16 == 0:
        def cost(rows):
            blocks = -(-N // TC_COLS) * -(-M // rows)
            if -(-M // rows) > MAX_GRID_Y:
                return float("inf")
            return -(-blocks // SMS) * (1.0 if rows == 128 else ONE_CONSUMER_COST)

        rows = min(TC_ROWS, key=cost)  # the first, 128, at a tie
        return QuantPlan("wgmma", rows, TC_COLS, False, M, N)
    vec = K % 4 == 0 and x_align % 16 == 0 and q_align % 4 == 0
    return QuantPlan("simt", SIMT_ROWS, SIMT_COLS, vec, M, N)


def quant_plan(M: int, N: int, K: int, x_ptr: int = 0, q_ptr: int = 0) -> QuantPlan:
    """K7's plan for x (M, K) at address x_ptr and q (N, K) at q_ptr.

    "wgmma" wherever 16-byte loads address every row of x and q (K % 16
    == 0, both 16-byte aligned), with 128 or 64 rows per block by waves:
    the fewer rounds of 132 blocks, each round costing a 128-row block's
    time or ONE_CONSUMER_COST of it, 128 rows at a tie. Otherwise
    "simt", with 16-byte loads of x where K % 4 == 0 and x is 16-byte
    aligned (and q 4-byte aligned)."""
    return _plan(M, N, K, x_ptr % 16, q_ptr % 16)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      weight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(x @ float(q)^T) * scale (+ bias): x (M, K), q (N, K), scale and bias
    (N,) -> (M, N) f32, the kernel's order of operations. With
    `weight_dtype=torch.bfloat16`: x @ w^T (+ bias) for the weight w =
    bf16(bf16(q) * bf16(scale)) widened to f32."""
    if weight_dtype == torch.float32:
        y = (x.float() @ q.float().T) * scale.float()
    else:
        y = x.float() @ (q.to(weight_dtype) * scale.to(weight_dtype)[:, None]).float().T
    return y if bias is None else y + bias.float()


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None = None,
                weight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7. x (M, K) f32, q (N, K) int8, scale (N,) f32, bias (N,) f32 or
    None -> y (M, N) f32, a new tensor. `weight_dtype` (f32 or bf16) is
    the dtype the weight is widened to, as `int8_matmul_plain` says."""
    if weight_dtype not in _MODES:
        raise ValueError(f"int8_matmul widens to f32 or bf16, not {weight_dtype}")
    return build.call_op("int8_matmul", _int8_matmul_op, x, q, scale, bias, weight_dtype)


def _int8_matmul_cuda(x, q, scale, bias, weight_dtype):
    ts = (x, q, scale) if bias is None else (x, q, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "int8_matmul writes its CUDA result through raw pointers, which would "
            "drop the gradient, and quantized weights are for inference; call it "
            "under torch.no_grad()")
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"int8_matmul: want x (M, K) and q (N, K), got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[0]
    for name, t, dtype, shape in (("x", x, torch.float32, (M, K)),
                                  ("q", q, torch.int8, (N, K)),
                                  ("scale", scale, torch.float32, (N,)),
                                  ("bias", bias, torch.float32, (N,))):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"int8_matmul takes {name} as {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"int8_matmul: want {name} {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    if not (1 <= M <= MAX_GRID_Y * SIMT_ROWS and 1 <= N < 2 ** 31 and 1 <= K < 2 ** 31):
        raise ValueError(f"int8_matmul: M={M}, N={N}, K={K} out of range")
    return launch_plan(x, q, scale, bias, quant_plan(M, N, K, x.data_ptr(), q.data_ptr()),
                       weight_dtype)


def launch_plan(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None, plan: QuantPlan,
                weight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch K7 in the form and tiles of `plan` and the weight mode of
    `weight_dtype` on checked CUDA operands; the one place K7 launches
    (`int8_matmul` checks and plans)."""
    M, K = x.shape
    N = q.shape[0]
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    ptrs = (x.data_ptr(), q.data_ptr(), scale.data_ptr(),
            0 if bias is None else bias.data_ptr(), y.data_ptr())
    mode = _MODES[weight_dtype]
    if plan.form == "wgmma":
        fn = build.entry_point(SOURCE, "int8_matmul_wgmma_f32", 5, 5)
        build.launch("int8_matmul", fn, x.device, *ptrs, M, N, K, plan.consumers, mode)
    else:
        fn = build.entry_point(SOURCE, "int8_matmul_f32", 5, 5)
        build.launch("int8_matmul", fn, x.device, *ptrs, M, N, K, int(plan.vec), mode)
    int8_matmul.launches += 1
    int8_matmul.form_launches[plan.form] += 1
    int8_matmul.launches_by_dtype[str(weight_dtype)[6:]] += 1
    return y


_int8_matmul_op = build.define_op(
    "int8_matmul",
    "(Tensor x, Tensor q, Tensor scale, Tensor? bias, ScalarType weight_dtype) -> Tensor",
    _int8_matmul_cuda, int8_matmul_plain,
    lambda x, q, scale, bias, weight_dtype: x.new_empty(x.shape[0], q.shape[0],
                                                        dtype=torch.float32))

int8_matmul.launches = 0
int8_matmul.form_launches = {"wgmma": 0, "simt": 0}
int8_matmul.launches_by_dtype = {"float32": 0, "bfloat16": 0}

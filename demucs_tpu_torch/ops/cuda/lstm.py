"""The BiLSTM recurrence: the CUDA kernel's wrapper (K6) and its plain twin.

`bilstm_recurrence` (K6, `csrc/bilstm.cu`) replaces the Pallas TPU
kernel `demucs_tpu/ops/pallas/lstm.py:bilstm_recurrence`
(`_bilstm_kernel`): both directions of one BiLSTM layer's recurrence in
one launch, from the projected inputs xs (T, 2, B, 4H) (direction 1
time-flipped) and the recurrent weights w_hh (2, H, 4H) to the hidden
states ys (T, 2, B, H), gate order i, f, g, o, h and c from zero. It
takes f32 or bf16 xs and w_hh, as the TPU kernel does: the gates, their
sums and the cell state c are f32 in either, h is rounded to the input
dtype each step (it feeds the next step's product and ys). The v3 model
runs it 8 times per segment batch (encoders 4 and 5 x 2 DConv sub-blocks
x 2 LSTM layers), through `ops.lstm.bilstm`.

What bounds it on an H100: not the flops (16·T·B·H²) nor the bytes, but
the T dependent steps, each of which needs all of h from the step
before. The kernel is one thread-block cluster (16 blocks, else 8) per
direction and group of up to 8 batch rows: each block holds its hidden
units' gate columns of w_hh in shared memory for the whole scan and
stores its units' h into every block of the cluster through distributed
shared memory, with one cluster barrier per step. Its sequential floor
is that exchange and barrier alone (`launch_cluster_floor`); the source
says more, `PERF.md` has the times.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain twin for CPU tensors; it never falls back. It is bound as the
custom op `torch.ops.demucs_tpu_torch.bilstm_recurrence`. It raises on CUDA
inputs that require grad under grad mode: the kernel writes through raw
pointers, which would drop the gradient; training differentiates K6
through `ops.lstm.BiLSTMRecurrence`.
`launches` counts the kernel launches, `launches_by_dtype` those of each
input dtype.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = "bilstm"
SOURCES = (SOURCE,)
MAX_HIDDEN = 512  # csrc/bilstm.cu kMaxHidden
MAX_ROWS = 8      # batch rows per cluster (csrc/bilstm.cu kMaxRows)


def bilstm_recurrence_plain(xs: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """A torch loop over T with the kernel's gate maths, as the TPU
    kernel `demucs_tpu/ops/pallas/lstm.py:_bilstm_kernel` computes them:
    xs (T, 2, B, 4H), w_hh (2, H, 4H) -> ys (T, 2, B, H) in xs's dtype.
    The gates (xs[t] plus h @ w_hh, summed in f32), their nonlinearities
    and the cell state c are f32; h is rounded to xs's dtype each step
    before it feeds the next product and ys. In f32 this is the
    `demucs_tpu/ops/lstm.py:_scan_recurrence` recurrence."""
    T, _, B, H4 = xs.shape
    h = xs.new_zeros(2, B, H4 // 4)
    c = torch.zeros(h.shape, dtype=torch.float32, device=xs.device)
    w = w_hh.float()
    ys = []
    for t in range(T):
        gates = xs[t].float() + torch.bmm(h.float(), w)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xs.dtype)
        ys.append(h)
    return torch.stack(ys)


def _check(xs: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xs.device != w_hh.device:
        raise ValueError(f"xs on {xs.device}, w_hh on {w_hh.device}")
    if torch.is_grad_enabled() and (xs.requires_grad or w_hh.requires_grad):
        raise RuntimeError(
            "bilstm_recurrence writes its CUDA result through raw pointers, which "
            "would drop the gradient; differentiate through ops.lstm.BiLSTMRecurrence "
            "(or call this under torch.no_grad())")
    if xs.dtype not in build.DTYPE_SUFFIX or w_hh.dtype != xs.dtype:
        raise ValueError(f"bilstm_recurrence takes f32 or bf16 xs and w_hh of one dtype, "
                         f"got {xs.dtype}, {w_hh.dtype}")
    if xs.ndim != 4 or xs.shape[1] != 2 or xs.shape[3] % 4:
        raise ValueError(f"want xs (T, 2, B, 4H), got {tuple(xs.shape)}")
    T, _, B, H4 = xs.shape
    H = H4 // 4
    if tuple(w_hh.shape) != (2, H, H4):
        raise ValueError(f"want w_hh (2, {H}, {H4}) for xs {tuple(xs.shape)}, "
                         f"got {tuple(w_hh.shape)}")
    if T < 1 or B < 1 or not 1 <= H <= MAX_HIDDEN or -(-B // MAX_ROWS) > 65535:
        raise ValueError(f"empty or oversized recurrence: T={T}, B={B}, H={H} "
                         f"(1 <= H <= {MAX_HIDDEN})")
    for name, t in (("xs", xs), ("w_hh", w_hh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bilstm_recurrence_cuda(xs: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    _check(xs, w_hh)
    T, _, B, H4 = xs.shape
    ys = torch.empty(T, 2, B, H4 // 4, device=xs.device, dtype=xs.dtype)
    fn = build.entry_point(SOURCE, f"bilstm_recurrence_{build.DTYPE_SUFFIX[xs.dtype]}", 3, 3)
    build.launch("bilstm_recurrence", fn, xs.device,
                 xs.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), T, B, H4 // 4)
    bilstm_recurrence.launches += 1
    bilstm_recurrence.launches_by_dtype[str(xs.dtype)[6:]] += 1
    return ys


_bilstm_recurrence_op = build.define_op(
    "bilstm_recurrence", "(Tensor xs, Tensor w_hh) -> Tensor",
    _bilstm_recurrence_cuda, bilstm_recurrence_plain,
    lambda xs, w_hh: xs.new_empty(*xs.shape[:3], xs.shape[3] // 4))


def bilstm_recurrence(xs: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """K6. xs (T, 2, B, 4H), w_hh (2, H, 4H), both f32 or both bf16 -> ys
    (T, 2, B, H) in their dtype, direction 1 still in flipped time order
    (the caller un-flips)."""
    return build.call_op("bilstm_recurrence", _bilstm_recurrence_op, xs, w_hh)


def _launch_floor(entry: str, t_len: int, batch: int, hidden: int,
                  device: str | torch.device) -> None:
    scratch = torch.empty(1, device=device)
    fn = build.entry_point(SOURCE, entry, 1, 3)
    build.launch(entry, fn, scratch.device, scratch.data_ptr(), t_len, batch, hidden)


def launch_cluster_floor(t_len: int, batch: int, hidden: int,
                         device: str | torch.device = "cuda") -> None:
    """Launch K6's sequential floor on `device`: K6's grid, clusters and
    shared memory at this shape, running `t_len` steps of nothing but the
    exchange of h through distributed shared memory and one cluster
    barrier each. For measurement only; it computes nothing and counts no
    K6 launch."""
    _launch_floor("bilstm_cluster_floor", t_len, batch, hidden, device)


def launch_block_floor(t_len: int, batch: int, hidden: int,
                       device: str | torch.device = "cuda") -> None:
    """The first form's floor, for comparison: one block per direction and
    pair of rows, `t_len` steps of an exchange through one block's shared
    memory and `__syncthreads`."""
    _launch_floor("bilstm_block_floor", t_len, batch, hidden, device)


bilstm_recurrence.launches = 0
bilstm_recurrence.launches_by_dtype = {"float32": 0, "bfloat16": 0}

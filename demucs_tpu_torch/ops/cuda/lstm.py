"""The BiLSTM recurrence: the CUDA kernel's wrapper (K6) and its plain twin.

`bilstm_recurrence` (K6, `csrc/bilstm.cu`) replaces the Pallas TPU
kernel `demucs_tpu/ops/pallas/lstm.py:bilstm_recurrence`
(`_bilstm_kernel`): both directions of one BiLSTM layer's recurrence in
one launch, from the projected inputs xs (T, 2, B, 4H) (direction 1
time-flipped) and the recurrent weights w_hh (2, H, 4H) to the hidden
states ys (T, 2, B, H), gate order i, f, g, o, h and c from zero, all in
f32. The v3 model runs it 8 times per segment batch (encoders 4 and 5 x
2 DConv sub-blocks x 2 LSTM layers), through `ops.lstm.bilstm`.

What bounds it on an H100: not the flops (16·T·B·H²) nor the bytes, but
the T dependent steps, each of which needs all of h from the step
before. In this first form each step is one SM's pass over w_hh from
L2, far above the sequential floor (T barrier steps and nothing else);
the source says more, `PERF.md` has the times.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain twin for CPU tensors; it never falls back. It takes f32 only, and
it raises on CUDA inputs that require grad under grad mode: the kernel
writes through raw pointers, which would drop the gradient, and v3
training is not ported. `launches` counts the kernel launches.
"""

from __future__ import annotations

import torch

from . import build

SOURCE = "bilstm"
SOURCES = (SOURCE,)
MAX_HIDDEN = 512  # one thread per hidden unit (csrc/bilstm.cu kMaxHidden)


def bilstm_recurrence_plain(xs: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """A torch loop over T with the kernel's gate maths, as
    `demucs_tpu/ops/lstm.py:_scan_recurrence`: xs (T, 2, B, 4H), w_hh
    (2, H, 4H) -> ys (T, 2, B, H)."""
    T, _, B, H4 = xs.shape
    h = xs.new_zeros(2, B, H4 // 4)
    c = torch.zeros_like(h)
    ys = []
    for t in range(T):
        gates = xs[t] + torch.bmm(h, w_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys)


def _check(xs: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xs.device != w_hh.device:
        raise ValueError(f"xs on {xs.device}, w_hh on {w_hh.device}")
    if torch.is_grad_enabled() and (xs.requires_grad or w_hh.requires_grad):
        raise RuntimeError(
            "bilstm_recurrence writes its CUDA result through raw pointers, which "
            "would drop the gradient, and v3 training is not ported; call it "
            "under torch.no_grad()")
    if xs.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise ValueError(f"bilstm_recurrence takes f32 only, got {xs.dtype}, {w_hh.dtype}")
    if xs.ndim != 4 or xs.shape[1] != 2 or xs.shape[3] % 4:
        raise ValueError(f"want xs (T, 2, B, 4H), got {tuple(xs.shape)}")
    T, _, B, H4 = xs.shape
    H = H4 // 4
    if tuple(w_hh.shape) != (2, H, H4):
        raise ValueError(f"want w_hh (2, {H}, {H4}) for xs {tuple(xs.shape)}, "
                         f"got {tuple(w_hh.shape)}")
    if T < 1 or B < 1 or not 1 <= H <= MAX_HIDDEN or (B + 1) // 2 > 65535:
        raise ValueError(f"empty or oversized recurrence: T={T}, B={B}, H={H} "
                         f"(1 <= H <= {MAX_HIDDEN})")
    for name, t in (("xs", xs), ("w_hh", w_hh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bilstm_recurrence(xs: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """K6. xs (T, 2, B, 4H), w_hh (2, H, 4H) f32 -> ys (T, 2, B, H) f32,
    direction 1 still in flipped time order (the caller un-flips)."""
    if build.on_cpu("bilstm_recurrence", xs, w_hh):
        return bilstm_recurrence_plain(xs, w_hh)
    _check(xs, w_hh)
    T, _, B, H4 = xs.shape
    ys = torch.empty(T, 2, B, H4 // 4, device=xs.device, dtype=torch.float32)
    fn = build.entry_point(SOURCE, "bilstm_recurrence_f32", 3, 3)
    build.launch("bilstm_recurrence", fn, xs.device,
                 xs.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), T, B, H4 // 4)
    bilstm_recurrence.launches += 1
    return ys


def launch_barrier_floor(t_len: int, batch: int, hidden: int,
                         device: str | torch.device = "cuda") -> None:
    """Launch K6's sequential floor on `device`: the grid and block K6 takes
    at this shape, running `t_len` steps of nothing but an exchange of h
    through shared memory and one barrier each. For measurement only; it
    computes nothing and counts no K6 launch."""
    scratch = torch.empty(1, device=device)
    fn = build.entry_point(SOURCE, "bilstm_barrier_floor", 1, 3)
    build.launch("bilstm_barrier_floor", fn, scratch.device,
                 scratch.data_ptr(), t_len, batch, hidden)


bilstm_recurrence.launches = 0

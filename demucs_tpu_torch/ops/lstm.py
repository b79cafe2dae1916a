"""Bidirectional multi-layer LSTM (PyTorch gate order i, f, g, o).

The port of `demucs_tpu/ops/lstm.py:bilstm`. Per layer, the input
projection of the whole sequence, both directions, is one matmul outside
the recurrence; the recurrence of both directions is one call of
`ops.cuda.bilstm_recurrence`: the CUDA kernel K6 on CUDA tensors, its
plain twin on CPU tensors. There is no other path: a CUDA tensor runs K6
or the wrapper raises. In grad mode the call goes through
`BiLSTMRecurrence` on either device: K6 forward, and a backward that
recomputes the recurrence through the plain twin under autograd from the
saved xs and w_hh, as `demucs_tpu/ops/lstm.py:_rec_bwd` recomputes it
through the scan (neither package has a backward kernel for it).

A layer's weights enter in the packed form of `pack_bilstm_layer`: both
directions' input weights stacked, both biases summed, the recurrent
weights transposed into K6's (2, H, 4H). `models/hdemucs_v3.py:BLSTM`
packs once and keeps the result while its parameters stay the same;
`bilstm` packs on every call.
"""

from __future__ import annotations

import torch

from .cuda import bilstm_recurrence, bilstm_recurrence_plain
from .recompute import recomputed

# forward(xs (T, 2, B, 4H), w_hh (2, H, 4H)) -> ys (T, 2, B, H): K6
BiLSTMRecurrence = recomputed("BiLSTMRecurrence", bilstm_recurrence,
                              bilstm_recurrence_plain, 2)

# (w_ih (8H, C): forward rows then reverse rows, bias (8H,): bias_ih +
# bias_hh of each direction, w_hh (2, H, 4H): each direction's weight_hh
# transposed, contiguous)
PackedLayer = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pack_bilstm_layer(layer: dict) -> PackedLayer:
    """One layer's torch.nn.LSTM tensors ({'forward': {...}, 'reverse':
    {...}}, each weight_ih (4H, C), weight_hh (4H, H), bias_ih, bias_hh
    (4H,)) in the form `bilstm_packed` takes."""
    fwd, rev = layer["forward"], layer["reverse"]
    w_ih = torch.cat([fwd["weight_ih"], rev["weight_ih"]])
    bias = torch.cat([fwd["bias_ih"] + fwd["bias_hh"], rev["bias_ih"] + rev["bias_hh"]])
    w_hh = torch.stack([fwd["weight_hh"].t(), rev["weight_hh"].t()]).contiguous()
    return w_ih, bias, w_hh


def _bilstm_layer(x: torch.Tensor, packed: PackedLayer) -> torch.Tensor:
    """One bidirectional layer: x (B, T, C) -> (B, T, 2H). Direction 1
    runs on the time-flipped sequence, so both directions step together
    through one (T, 2, B, 4H) recurrence."""
    w_ih, bias, w_hh = packed
    B, T, _ = x.shape
    H = w_hh.shape[1]
    xp = (torch.matmul(x, w_ih.to(x.dtype).t()) + bias.to(x.dtype)).reshape(B, T, 2, 4 * H)
    xp = xp.permute(1, 2, 0, 3)                                # (T, 2, B, 4H)
    xs = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1)       # dir 1 flipped
    rec = BiLSTMRecurrence.apply if torch.is_grad_enabled() else bilstm_recurrence
    ys = rec(xs, w_hh.to(x.dtype))                             # (T, 2, B, H)
    return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1).transpose(0, 1)


def bilstm_packed(x: torch.Tensor, layers: list[PackedLayer]) -> torch.Tensor:
    """`bilstm` on layers already packed by `pack_bilstm_layer`."""
    h = x
    for packed in layers:
        h = _bilstm_layer(h, packed)
    return h


def bilstm(x: torch.Tensor, layers: list[dict]) -> torch.Tensor:
    """x: (B, T, C); layers[i] = {'forward': {...}, 'reverse': {...}}, each
    with weight_ih (4H, C_i), weight_hh (4H, H), bias_ih, bias_hh (4H,)
    (torch.nn.LSTM's tensors of layer i).

    Returns (B, T, 2H): per step the concatenation of both directions,
    each layer consuming the previous one's output, as torch.nn.LSTM
    (bidirectional=True, num_layers=len(layers)).
    """
    return bilstm_packed(x, [pack_bilstm_layer(layer) for layer in layers])

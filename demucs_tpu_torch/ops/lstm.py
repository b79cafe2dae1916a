"""Bidirectional multi-layer LSTM (PyTorch gate order i, f, g, o).

The port of `demucs_tpu/ops/lstm.py:bilstm`. Per layer, the input
projection of the whole sequence, both directions, is one matmul outside
the recurrence; the recurrence of both directions is one call of
`ops.cuda.bilstm_recurrence`: the CUDA kernel K6 on CUDA tensors, its
plain twin on CPU tensors. There is no other path: a CUDA tensor runs K6
or the wrapper raises.
"""

from __future__ import annotations

import torch

from .cuda import bilstm_recurrence


def _bilstm_layer(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """One bidirectional layer: x (B, T, C) -> (B, T, 2H). Direction 1
    runs on the time-flipped sequence, so both directions step together
    through one (T, 2, B, 4H) recurrence."""
    B, T, _ = x.shape
    fwd, rev = layer["forward"], layer["reverse"]
    H = fwd["weight_hh"].shape[-1]
    w_ih = torch.cat([fwd["weight_ih"], rev["weight_ih"]]).to(x.dtype)  # (8H, C)
    bias = torch.cat([fwd["bias_ih"] + fwd["bias_hh"],
                      rev["bias_ih"] + rev["bias_hh"]]).to(x.dtype)
    xp = (torch.matmul(x, w_ih.t()) + bias).reshape(B, T, 2, 4 * H)
    xp = xp.permute(1, 2, 0, 3)                                # (T, 2, B, 4H)
    xs = torch.stack([xp[:, 0], xp[:, 1].flip(0)], dim=1)       # dir 1 flipped
    w_hh = torch.stack([fwd["weight_hh"].t(), rev["weight_hh"].t()]).to(x.dtype)
    ys = bilstm_recurrence(xs, w_hh.contiguous())              # (T, 2, B, H)
    return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1).transpose(0, 1)


def bilstm(x: torch.Tensor, layers: list[dict]) -> torch.Tensor:
    """x: (B, T, C); layers[i] = {'forward': {...}, 'reverse': {...}}, each
    with weight_ih (4H, C_i), weight_hh (4H, H), bias_ih, bias_hh (4H,)
    (torch.nn.LSTM's tensors of layer i).

    Returns (B, T, 2H): per step the concatenation of both directions,
    each layer consuming the previous one's output, as torch.nn.LSTM
    (bidirectional=True, num_layers=len(layers)).
    """
    h = x
    for layer in layers:
        h = _bilstm_layer(h, layer)
    return h

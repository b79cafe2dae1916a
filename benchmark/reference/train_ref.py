"""Plain training steps of the reference model, and the draws both sides
are handed.

The benchmark draws each step's augmentation (`draw`, in the order the
port's `data.draw_augmentation` draws: channel flip, sign, gain, then
Remix's permutations) from its own generator and hands the same draws to
the program and to this reference. The rows of each batch are worked
out again here from the seed (`sampler_rows`: a track uniformly, then an
offset uniformly, from `numpy.random.default_rng(seed)`, the upstream
trainer's and the port's rule), the augmentation applied by this
module's own copy (`augment`), the mix taken as the stems' sum, the loss
as the mean L1 over every element, and the update by `torch.optim.Adam`
with the training CLI's settings. The forward and backward run in blocks
of rows (`block`), each block's summed L1 divided by the whole batch's
element count, so the accumulated gradient is the whole batch's.
"""

from __future__ import annotations

import numpy as np
import torch

from .track import f32_exact

GAIN_MIN, GAIN_MAX = 0.75, 1.25


def draw(shape, gen: torch.Generator):
    """(flip, sign, scale, perms) for a (B, S, C, T) batch."""
    B, S = shape[:2]
    dev = gen.device
    flip = torch.rand(B, S, generator=gen, device=dev) < 0.5
    sign = torch.randint(0, 2, (B, S), generator=gen, device=dev) * 2 - 1
    scale = GAIN_MIN + (GAIN_MAX - GAIN_MIN) * torch.rand(B, S, generator=gen, device=dev)
    perms = None
    if B > 1:
        perms = torch.stack([torch.randperm(B, generator=gen, device=dev) for _ in range(S)],
                            dim=1)
    return flip, sign, scale, perms


def augment(stems, flip, sign, scale, perms):
    """Channel flip, sign and gain per (row, source), then Remix: row b of
    source s is row perms[b, s] of source s."""
    out = torch.empty_like(stems)
    for b in range(stems.shape[0]):
        for s in range(stems.shape[1]):
            x = stems[b, s].flip(0) if bool(flip[b, s]) else stems[b, s]
            out[b, s] = x * (float(sign[b, s]) * float(scale[b, s]))
    if perms is not None:
        out = torch.stack([torch.stack([out[int(perms[b, s]), s] for s in range(out.shape[1])])
                           for b in range(out.shape[0])])
    return out


def sampler_rows(tracks: list[np.ndarray], segment: int, batch: int, seed: int, steps: int):
    """The (steps, B, S, C, segment) rows the uniform sampler draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        rows = []
        for _ in range(batch):
            t = tracks[rng.integers(len(tracks))]
            off = rng.integers(t.shape[-1] - segment + 1)
            rows.append(t[:, :, off:off + segment])
        out.append(np.stack(rows))
    return out


def train(model: torch.nn.Module, batches, lr: float, block: int, tf32: bool = False,
          drop_half: bool = False) -> dict:
    """Steps of Adam on the augmented `batches` (a list of (stems on the
    device, draws)). -> {"losses": [...], "grad_norms": {name: norm} of
    the first step's gradient, "change_norms": {name: ||p - p0||} after
    the last step}. `drop_half` plants a fault for the harness's tests:
    each step's loss over the first half of the rows only."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, grad_norms = [], None
    with f32_exact(tf32):
        for stems, draws in batches:
            stems = augment(stems, *draws)
            rows = stems.shape[0] // 2 if drop_half else stems.shape[0]
            opt.zero_grad(set_to_none=True)
            total = 0.0
            for i in range(0, rows, block):
                part = stems[i:min(i + block, rows)]
                est = model(part.sum(dim=1))
                loss = (est - part).abs().sum() / (part[0].numel() * rows)
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            if grad_norms is None:
                grad_norms = {n: float(p.grad.norm()) for n, p in params.items()}
            opt.step()
    change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell:
      loss_gap: the worst step's |loss - ref| / ref;
      grad_gap: the worst leaf's gap of first-gradient norms, over the
        larger of its reference norm and the median leaf's;
      change_gap: the same of the parameters' change over the steps,
        leaving out the leaves whose reference gradient is below a
        thousandth of the median leaf's (they move under Adam by
        round-off alone)."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]) or \
            len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_med = float(np.median(list(ref["grad_norms"].values())))
    grad_gap = max(abs(prog["grad_norms"][n] - r) / max(r, g_med)
                   for n, r in ref["grad_norms"].items())
    moved = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * g_med]
    c_med = float(np.median([ref["change_norms"][n] for n in moved]))
    change_gap = max(abs(prog["change_norms"][n] - ref["change_norms"][n])
                     / max(ref["change_norms"][n], c_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

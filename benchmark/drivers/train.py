"""Training with the training CLI's defaults: `train.TrainStep` (Adam at
the CLI's learning rate, no EMA, no remat, f32 with TF32 off,
deterministic cuDNN) fed by `data.SegmentSampler` over synthetic stems
made from the seed, each batch augmented through `data.augmented_step`
with draws the benchmark makes itself.

Set-up builds one `TrainStep` and drives it through the first
`check_steps` steps, reading what the check compares: each step's loss,
the first gradient's norm per weight (from Adam's first moment after
step 1, which is a tenth of it), and each weight's change after the last
of them. The window then runs further steps of the same object until
`--seconds` have passed; the rate is all the audio-seconds of mix trained
(steps x batch x segment) over all the window's wall time. The check
follows the first steps with the reference (`reference/train_ref.py`)
once the program's state is freed.
"""

from __future__ import annotations

import time

import torch

from ..harness import program, signals
from ..harness.core import Run
from ..harness.trace import Stretch, merged
from ..harness.weights import generator
from ..reference import train_ref
from .common import Marks, peak_bytes, reference_on, release, sync


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([t.norm() for t in tensors.values()]).tolist()
    return dict(zip(names, values))


def measure(run: Run, t_start: float) -> dict:
    from demucs_tpu_torch.data import Augmentation, SegmentSampler, augmented_step
    from demucs_tpu_torch.train import ADAM_BETAS, TrainStep

    cfg, tr, dev = run.cfg, run.traffic, run.device
    seg, B = cfg["apply"]["segment_samples"], tr["batch"]
    marks = Marks(t_start)
    marks("imports")
    weights = program.seeded_weights(cfg, run.seed, dev)
    step = TrainStep(program.build(cfg, weights, dev, train=True), lr=tr["lr"])
    marks("model")
    tracks = signals.stem_tracks(tr["tracks"], tr["track_s"], run.seed, dev)
    sampler = SegmentSampler(tracks, seg, seed=run.seed)
    gen = generator(run.seed, dev, salt=4)
    marks("stems")

    def one_step():
        stems = torch.from_numpy(sampler.batch(B)).to(dev)
        return augmented_step(step, stems, Augmentation(*train_ref.draw(stems.shape, gen)))

    params = dict(step.model.named_parameters())
    losses, grad_norms = [], None
    for _ in range(tr["check_steps"]):
        losses.append(float(one_step()))
        if grad_norms is None:
            # a weight the optimizer has no moment for got no gradient
            none = torch.zeros(1, device=dev)
            moments = {n: step.optimizer.state.get(p, {}).get("exp_avg", none)
                       for n, p in params.items()}
            grad_norms = {n: v / (1 - ADAM_BETAS[0]) for n, v in _norms(moments).items()}
    change = _norms({n: p.detach() - weights[n] for n, p in params.items()})
    sync(dev)
    marks(f"{tr['check_steps']} steps")
    run.setup_s = marks.report("set-up")

    steps = traced_steps = 0
    traced_s = 0.0
    traced: dict = {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        if run.trace and steps == 1:
            # steps with host activity and shapes, then steps with device
            # activity alone (see harness/trace.py)
            t_tr = time.perf_counter()
            for kind in ("shapes", "timing"):
                with Stretch(True, dev, shapes=kind == "shapes") as stretch:
                    for _ in range(tr["traced_steps"]):
                        one_step()
                traced[kind] = stretch.read()
            traced_steps = 2 * tr["traced_steps"]
            traced_s = time.perf_counter() - t_tr
            steps += traced_steps
            continue
        one_step()
        steps += 1
    sync(dev)
    run.window_s = time.perf_counter() - t0
    if traced:
        run.summary = merged(traced["shapes"], traced["timing"])
    audio = steps * B * seg / cfg["apply"]["sample_rate"]
    run.attempted = steps
    run.e2e["train_audio_s_per_s"] = audio / run.window_s
    run.counters.update(steps=steps, audio_s=audio,
                        operations=(steps - traced_steps) * B
                        * cfg["training_operations_per_segment"],
                        operations_s=run.window_s - traced_s)
    run.memory_peak_bytes = peak_bytes(dev)
    del step, params, weights
    release(dev)
    return {"tracks": tracks, "program": {"losses": losses, "grad_norms": grad_norms,
                                          "change_norms": change}}


def reference_steps(run: Run, kept: dict, tf32: bool = False, drop_half: bool = False) -> dict:
    """The reference's first steps on the same rows and draws."""
    tr, dev = run.traffic, run.device
    rows = train_ref.sampler_rows(kept["tracks"], run.cfg["apply"]["segment_samples"],
                                  tr["batch"], run.seed, tr["check_steps"])
    gen = generator(run.seed, dev, salt=4)
    batches = []
    for r in rows:
        stems = torch.from_numpy(r).to(dev)
        batches.append((stems, train_ref.draw(stems.shape, gen)))
    model = reference_on(run).train()
    out = train_ref.train(model, batches, tr["lr"], run.cfg["reference_train_block"],
                          tf32=tf32, drop_half=drop_half)
    del model, batches
    release(dev)
    return out


def check(run: Run, kept: dict, cache=None) -> dict:
    ref = reference_steps(run, kept)
    kept["reference"] = ref
    return train_ref.gaps(kept["program"], ref)


def control(run: Run, kept: dict, cache=None) -> dict:
    """The reference with TF32 on in the program's place."""
    ref = kept.get("reference") or reference_steps(run, kept)
    return train_ref.gaps(reference_steps(run, kept, tf32=True), ref)

"""Trainer: MUSDB-layout stems (or synthetic data) -> checkpoint.

The port of `demucs_tpu/tools/train_cli.py` for single-device f32
training of the htdemucs families: `SegmentSampler` batches, augmentation
on the device (`data.py`), L1 + Adam with an optional EMA (`train.py`),
a crash-safe `torch.save` checkpoint with resume, and `--export-ggml` of
the final weights (the EMA when `--ema` is on, the upstream convention)
for the inference CLI.

Usage:
    python -m demucs_tpu_torch.tools.train_cli --data MUSDB/train \\
        [--family htdemucs_4s|htdemucs_6s] [--init-from MODEL.bin]
        [--steps 1000] [--batch 8] [--segment-samples 343980]
        [--lr 3e-4] [--ema 0.9999] [--ckpt FILE] [--save-every 500]
        [--resume] [--export-ggml OUT.bin] [--device cuda|cpu]
    python -m demucs_tpu_torch.tools.train_cli --synthetic --steps 5  # smoke

The run goes to the GPU unless `--device cpu` is given; without a GPU a
CUDA run fails. Each logged step prints its number, loss and step time
(seconds since the previous logged step, over the steps between them,
checkpoint saves left out; each save prints its own time).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import params as P
from ..config import (HTDEMUCS_4S, HTDEMUCS_6S, SAMPLE_RATE, SEGMENT_SAMPLES,
                      HDemucsV3Config)
from ..data import SegmentSampler, augmented_step, draw_augmentation, load_musdb_track
from ..models import build_htdemucs
from ..train import TrainStep, load_train_state, save_train_state
from ..utils.device import resolve_device

FAMILIES = {"htdemucs_4s": HTDEMUCS_4S, "htdemucs_6s": HTDEMUCS_6S}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="demucs-tpu-torch-train",
                                 description="demucs-tpu-torch trainer")
    ap.add_argument("--data", help="dir of MUSDB-layout track dirs ({stem}.wav files each)")
    ap.add_argument("--synthetic", action="store_true",
                    help="random training stems (smoke/benchmark)")
    ap.add_argument("--family", choices=tuple(FAMILIES), default=None,
                    help="model family (default htdemucs_4s; taken from "
                         "--init-from when given)")
    ap.add_argument("--init-from", dest="init_from",
                    help="warm-start weights from a ggml file (fine-tuning)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-samples", type=int, default=None,
                    help="training crop (default: the 7.8 s segment)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ema", type=float, default=None,
                    help="EMA decay of the weights (checkpointed; exported "
                         "by --export-ggml)")
    ap.add_argument("--ckpt", help="checkpoint file (torch.save)")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true",
                    help="resume params/optimizer/step/EMA from --ckpt")
    ap.add_argument("--export-ggml", dest="export_ggml",
                    help="write the final weights (the EMA with --ema) as a "
                         "ggml file for the inference CLI")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: cuda)")
    ap.add_argument("--test-tiny", action="store_true",
                    help=argparse.SUPPRESS)  # tests: shrink the model
    args = ap.parse_args(argv)
    if bool(args.data) == bool(args.synthetic):
        ap.error("provide exactly one of --data or --synthetic")
    if args.resume and not args.ckpt:
        ap.error("--resume needs --ckpt")
    if args.steps < 0 or args.batch < 1 or args.save_every < 1 or args.log_every < 1:
        ap.error("--steps must be >= 0, --batch, --save-every, --log-every >= 1")
    return ap, args


def _model_setup(ap, args):
    """-> (family, cfg, flat state dict)."""
    if args.init_from:
        cfg, state_dict = P.load_model_params(args.init_from)
        if isinstance(cfg, HDemucsV3Config):
            ap.error(f"--init-from {args.init_from}: training hdemucs_mmi (v3) is "
                     "not supported by demucs_tpu_torch yet")
        family = "htdemucs_6s" if cfg.num_sources == 6 else "htdemucs_4s"
        if args.family and args.family != family:
            ap.error(f"--family {args.family} conflicts with --init-from "
                     f"({args.init_from} is a {family} checkpoint)")
        print(f"initialized from {args.init_from} ({family})", file=sys.stderr)
        return family, cfg, state_dict
    family = args.family or "htdemucs_4s"
    cfg = FAMILIES[family]
    if args.test_tiny:  # CI-sized variant, as the JAX package's tests use
        cfg = dataclasses.replace(cfg, channels=8, bottom_channels=32, t_layers=3)
    schema = P.htdemucs_schema(cfg)
    return family, cfg, P.from_state_dict(P.init_flat(schema, seed=args.seed), schema)


def main(argv=None) -> int:
    ap, args = _parse(argv)
    device = resolve_device(args.device)
    family, cfg, state_dict = _model_setup(ap, args)
    seg = args.segment_samples or SEGMENT_SAMPLES
    rng = np.random.default_rng(args.seed)

    if args.synthetic:
        tracks = [(rng.standard_normal((cfg.num_sources, 2, 4 * seg)) * 0.05
                   ).astype(np.float32) for _ in range(2)]
    else:
        root = Path(args.data)
        dirs = sorted(d for d in root.iterdir() if d.is_dir())
        if not dirs:
            print(f"error: no track dirs in {root}", file=sys.stderr)
            return 1
        tracks = [load_musdb_track(d, stems=cfg.sources) for d in dirs]
        print(f"loaded {len(tracks)} tracks", file=sys.stderr)
    sampler = SegmentSampler(tracks, seg, seed=args.seed)

    model = build_htdemucs(cfg, state_dict, device, train=True)
    step_fn = TrainStep(model, lr=args.lr, ema_decay=args.ema)
    start = 0
    if args.resume:
        start = load_train_state(args.ckpt, step_fn)
        print(f"resumed at step {start}", file=sys.stderr)
    if start >= args.steps:
        print(f"nothing to do: resumed step {start} >= --steps {args.steps}; "
              "checkpoint left untouched", file=sys.stderr)
        return 0

    gen = torch.Generator(device=device).manual_seed(args.seed)
    loss = float("nan")
    t_log, last_logged = time.monotonic(), start
    for step in range(start + 1, args.steps + 1):
        stems = torch.from_numpy(sampler.batch(args.batch)).to(device)
        aug = draw_augmentation(stems.shape, gen)
        loss_dev = augmented_step(step_fn, stems, aug)
        if step % args.log_every == 0 or step == args.steps:
            loss = float(loss_dev)  # a host fetch: waits for the step
            now = time.monotonic()
            step_s = (now - t_log) / (step - last_logged)
            t_log, last_logged = now, step
            print(f"step {step}/{args.steps}  loss {loss:.6f}  step_s {step_s:.4f}  "
                  f"{args.batch * seg / SAMPLE_RATE / step_s:.2f} audio-s/s",
                  file=sys.stderr)
        if args.ckpt and step % args.save_every == 0 and step != args.steps:
            loss_dev.item()  # the steps' device work ends before the save's clock starts
            t0 = time.monotonic()
            save_train_state(args.ckpt, step_fn)
            secs = time.monotonic() - t0
            t_log += secs  # step_s times the training, not the checkpoint
            print(f"checkpointed at step {step} ({secs:.2f} s)", file=sys.stderr)
    if args.ckpt:
        save_train_state(args.ckpt, step_fn)
        print(f"final checkpoint at {args.ckpt}", file=sys.stderr)

    if args.export_ggml:
        flat = {k: v.detach().cpu().numpy() for k, v in step_fn.export_weights().items()}
        P.write_ggml(args.export_ggml, family, flat)
        which = "EMA" if args.ema is not None else "trained"
        print(f"exported {which} weights -> {args.export_ggml} ({family})",
              file=sys.stderr)
    print(f"done: final loss {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

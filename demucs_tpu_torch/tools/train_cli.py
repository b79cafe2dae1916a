"""Trainer: MUSDB-layout stems (or synthetic data) -> checkpoint.

The port of `demucs_tpu/tools/train_cli.py` for one device:
`SegmentSampler` batches, augmentation on the device (`data.py`), L1 +
Adam with the optional EMA, rematerialization, bf16 compute and K steps
per call (`train.py`), held-out evaluation with the best checkpoint, a
crash-safe `torch.save` checkpoint with resume, and `--export-ggml` of
the final weights (the EMA when `--ema` is on, the upstream convention)
for the inference CLI. It trains htdemucs-4s, htdemucs-6s and
hdemucs_mmi (`--family hdemucs_v3`).

Several processes (`--coordinator HOST:PORT --num-processes N
--process-id I [--tp T]`, one command per process): each process is one
rank on one card, `cuda:(I % card count)` (or the CPU with `--device
cpu`), joined with NCCL (gloo on the CPU) at the coordinator's address,
which rank 0's host serves. The ranks form a (dp, tp) mesh, tp inside a
host (`parallel.make_mesh`), and take `train.ShardedTrainStep`s:
every rank samples and augments the same global batch from the same seed
and trains on its dp slice (`--batch` must divide by dp), the
transformer's projections split over tp. Only rank 0 logs; checkpoints,
the evaluation, `--export-ggml` and `CKPT.best` come from the state
gathered from every rank (the single-device checkpoint format), and
`--resume` gives every rank its slice of it. `--steps-per-call > 1` is
single-process only, as in the JAX CLI; with one process `--tp` is not
read.

Usage:
    python -m demucs_tpu_torch.tools.train_cli --data MUSDB/train \\
        [--family htdemucs_4s|htdemucs_6s|hdemucs_v3]
        [--init-from MODEL.bin|CHECKPOINT_DIR]
        [--steps 1000] [--batch 8] [--segment-samples 343980]
        [--lr 3e-4] [--remat] [--remat-policy dots|none|dots_nb]
        [--bf16-compute] [--steps-per-call K] [--ema 0.9999]
        [--ckpt FILE] [--save-every 500] [--resume]
        [--eval-every N] [--eval-data MUSDB/valid] [--eval-sdr]
        [--export-ggml OUT.bin] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes N --process-id I [--tp T]]
    python -m demucs_tpu_torch.tools.train_cli --synthetic --steps 5  # smoke

The run goes to the GPU unless `--device cpu` is given; without a GPU a
CUDA run fails. Each logged step prints its number, loss and step time
(seconds since the previous logged step, over the steps between them,
checkpoint saves and evaluations left out; each save prints its own
time). With `--eval-every N` the EMA weights (the trained ones without
`--ema`) separate the held-out tracks every N steps and at the end,
through one reused `pipeline.Separator`: the L1 over the stems (and with
`--eval-sdr` each stem's median SDR over 1 s frames,
`tools/evaluate_sdr.py`) goes to stderr and, with `--ckpt`, to
`CKPT.eval.jsonl`; each new best L1 saves the training state to
`CKPT.best`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import params as P
from ..config import (HDEMUCS_V3, HTDEMUCS_4S, HTDEMUCS_6S, SAMPLE_RATE, SEGMENT_SAMPLES,
                      HDemucsV3Config)
from ..data import SegmentSampler, augmented_steps, draw_augmentation, load_musdb_track
from ..models import build_model
from ..parallel import (axis_group, axis_size, init_distributed, make_mesh,
                        shard_state_dict)
from ..pipeline import ApplyOptions, Separator
from ..train import (REMAT_POLICIES, ShardedTrainStep, TrainStep, load_train_state,
                     write_train_state)
from ..utils.device import resolve_device
from .evaluate_sdr import median_sdr

FAMILIES = {"htdemucs_4s": HTDEMUCS_4S, "htdemucs_6s": HTDEMUCS_6S, "hdemucs_v3": HDEMUCS_V3}
# ggml container kind per family (params/ggml.py:GGML_MAGICS)
GGML_KIND = {"htdemucs_4s": "htdemucs_4s", "htdemucs_6s": "htdemucs_6s",
             "hdemucs_v3": "hdemucs_mmi"}


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
                    help="warm-start weights from a ggml file or a checkpoint "
                         "directory (fine-tuning)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-samples", type=int, default=None,
                    help="training crop (default: the 7.8 s segment)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true",
                    help="torch.utils.checkpoint over the segment forward")
    ap.add_argument("--remat-policy", choices=tuple(REMAT_POLICIES), default="dots",
                    help="what --remat keeps (train.REMAT_POLICIES)")
    ap.add_argument("--bf16-compute", action="store_true",
                    help="bf16 forward/backward, f32 master weights + Adam")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps per call: K batches in one upload, "
                         "their K losses fetched once")
    ap.add_argument("--ema", type=float, default=None,
                    help="EMA decay of the weights (checkpointed; evaluated and "
                         "exported)")
    ap.add_argument("--ckpt", help="checkpoint file (torch.save)")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="evaluate the EMA (or current) weights on held-out "
                         "tracks every N steps: L1 to stderr and (with --ckpt) "
                         "to CKPT.eval.jsonl; the best so far saved to CKPT.best")
    ap.add_argument("--eval-data",
                    help="dir of held-out MUSDB-layout track dirs (default with "
                         "--synthetic: a held-out synthetic track)")
    ap.add_argument("--eval-sdr", action="store_true",
                    help="also report per-stem SDR (median over 1 s frames, "
                         "tools/evaluate_sdr.py) at each eval")
    ap.add_argument("--resume", action="store_true",
                    help="resume params/optimizer/step/EMA from --ckpt")
    ap.add_argument("--export-ggml", dest="export_ggml",
                    help="write the final weights (the EMA with --ema) as a "
                         "ggml file for the inference CLI")
    # several processes, one rank (one card) each
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address HOST:PORT (rank 0's host)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (several processes)")
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
    if args.num_processes > 1 and not args.coordinator:
        ap.error("--num-processes > 1 needs --coordinator")
    if not 0 <= args.process_id < args.num_processes:
        ap.error("--process-id must be in [0, --num-processes)")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.steps_per_call < 1:
        ap.error("--steps-per-call must be >= 1")
    if args.steps_per_call > 1 and args.num_processes > 1:
        ap.error("--steps-per-call > 1 is single-process only")
    if args.save_every % args.steps_per_call:
        ap.error("--save-every must be a multiple of --steps-per-call")
    if args.eval_every < 0:
        ap.error("--eval-every must be >= 0")
    if args.eval_every:
        if not (args.eval_data or args.synthetic):
            ap.error("--eval-every needs --eval-data (or --synthetic)")
        if args.eval_every % args.steps_per_call:
            ap.error("--eval-every must be a multiple of --steps-per-call")
    return ap, args


def _model_setup(ap, args, lead: bool = True):
    """-> (family, cfg, flat state dict)."""
    if args.init_from:
        cfg, state_dict = P.load_model_params(args.init_from)
        if isinstance(cfg, HDemucsV3Config):
            family = "hdemucs_v3"
        else:
            family = "htdemucs_6s" if cfg.num_sources == 6 else "htdemucs_4s"
        if args.family and args.family != family:
            ap.error(f"--family {args.family} conflicts with --init-from "
                     f"({args.init_from} is a {family} checkpoint)")
        if lead:
            print(f"initialized from {args.init_from} ({family})", file=sys.stderr)
        return family, cfg, state_dict
    family = args.family or "htdemucs_4s"
    cfg = FAMILIES[family]
    if family == "hdemucs_v3":
        if args.test_tiny:
            ap.error("--test-tiny supports the htdemucs families")
        schema = P.hdemucs_v3_schema(cfg)
    else:
        if args.test_tiny:  # CI-sized variant, as the JAX package's tests use
            cfg = dataclasses.replace(cfg, channels=8, bottom_channels=32, t_layers=3)
        schema = P.htdemucs_schema(cfg)
    return family, cfg, P.from_state_dict(P.init_flat(schema, seed=args.seed), schema)


def _tracks(root: Path, sources) -> list[np.ndarray] | None:
    dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if not dirs:
        print(f"error: no track dirs in {root}", file=sys.stderr)
        return None
    return [load_musdb_track(d, stems=sources) for d in dirs]


class Evaluator:
    """The held-out evaluation of the training loop, as the JAX CLI's
    `evaluate`: the EMA weights (else the trained ones) separate each
    held-out track through one `Separator`, built at the first call and
    given new weights in place at each later one; tracks the best L1 and
    saves the training state to `CKPT.best` at each new best. Over
    several ranks every rank calls it (the weights and the state are
    gathered), rank 0 evaluates, logs and writes, and tells the others
    whether the L1 improved."""

    def __init__(self, args, cfg, tracks: list[np.ndarray], seg: int, device,
                 lead: bool = True):
        self.args, self.cfg, self.tracks = args, cfg, tracks
        self.seg, self.device, self.lead = seg, device, lead
        self.sep = None
        self.best = {"l1": float("inf"), "step": -1}
        self.log = Path(str(args.ckpt) + ".eval.jsonl") if args.ckpt else None

    def __call__(self, step_fn: TrainStep, step_no: int) -> None:
        weights = step_fn.export_weights()
        improved = self.lead and self._evaluate(weights, step_fn.ema is not None, step_no)
        if dist.is_initialized():
            flag = [improved]
            dist.broadcast_object_list(flag, src=0)
            improved = flag[0]
        if improved and self.args.ckpt:
            state = step_fn.checkpoint_state()
            if self.lead:
                write_train_state(str(self.args.ckpt) + ".best", state)

    def _evaluate(self, weights: dict, ema: bool, step_no: int) -> bool:
        """Separate the held-out tracks with `weights`; log; returns
        whether the L1 is a new best."""
        if self.sep is None:
            model = build_model(self.cfg, {k: v.detach().clone() for k, v in weights.items()},
                                self.device)
            self.sep = Separator(model, self.cfg.num_sources,
                                 ApplyOptions(segment_samples=self.seg, shift_offset=0,
                                              batch_size=self.args.batch), self.device)
        else:  # new weights, the same modules
            self.sep.model.load_state_dict(weights)
        l1s, sdrs = [], []
        for stems in self.tracks:
            est = self.sep(stems.sum(0))
            l1s.append(float(np.mean(np.abs(est - stems))))
            if self.args.eval_sdr:
                sdrs.append([median_sdr(stems[i], est[i])
                             for i in range(self.cfg.num_sources)])
        l1 = float(np.mean(l1s))
        rec = {"step": step_no, "l1": l1, "weights": "ema" if ema else "params"}
        if sdrs:
            rec["sdr"] = {name: round(float(np.mean([s[i] for s in sdrs])), 3)
                          for i, name in enumerate(self.cfg.sources)}
        improved = l1 < self.best["l1"]
        if improved:
            self.best.update(l1=l1, step=step_no)
            rec["best"] = True
        extra = f"  sdr {rec.get('sdr')}" if sdrs else ""
        mark = "  (best)" if improved else ""
        print(f"eval @ step {step_no}: l1 {l1:.5f}{extra}{mark}", file=sys.stderr)
        if self.log is not None:
            with open(self.log, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return improved


def main(argv=None) -> int:
    ap, args = _parse(argv)
    if args.num_processes == 1:
        return _train(ap, args, resolve_device(args.device))
    device = init_distributed(args.process_id, args.num_processes,
                              f"tcp://{args.coordinator}", args.device)
    try:
        return _train(ap, args, device,
                      make_mesh(tp=args.tp, device_type=device.type))
    finally:
        dist.destroy_process_group()


def _train(ap, args, device: torch.device, mesh=None) -> int:
    """The training run on one device, or with `mesh` as this process's
    rank (rank 0 logs and writes)."""
    lead = args.process_id == 0
    say = (lambda msg: print(msg, file=sys.stderr)) if lead else (lambda msg: None)
    family, cfg, state_dict = _model_setup(ap, args, lead)
    seg = args.segment_samples or SEGMENT_SAMPLES
    rng = np.random.default_rng(args.seed)

    if args.synthetic:
        tracks = [(rng.standard_normal((cfg.num_sources, 2, 4 * seg)) * 0.05
                   ).astype(np.float32) for _ in range(2)]
    else:
        tracks = _tracks(Path(args.data), cfg.sources)
        if tracks is None:
            return 1
        say(f"loaded {len(tracks)} tracks")
    # every rank draws the same global batches (and augmentations) from the
    # same seed; a ShardedTrainStep takes its rank's dp slice of each
    sampler = SegmentSampler(tracks, seg, seed=args.seed)

    evaluate = None
    if args.eval_every:
        if args.eval_data:
            eval_tracks = _tracks(Path(args.eval_data), cfg.sources)
            if eval_tracks is None:
                return 1
        else:  # --synthetic: one held-out synthetic track
            ev_rng = np.random.default_rng(args.seed + 10_000)
            eval_tracks = [(ev_rng.standard_normal((cfg.num_sources, 2, 2 * seg + 1001))
                            * 0.05).astype(np.float32)]
        say(f"eval set: {len(eval_tracks)} held-out track(s)")
        evaluate = Evaluator(args, cfg, eval_tracks, seg, device, lead)

    options = dict(lr=args.lr, ema_decay=args.ema, remat=args.remat,
                   remat_policy=args.remat_policy,
                   compute_dtype=torch.bfloat16 if args.bf16_compute else None)
    if mesh is None:
        step_fn = TrainStep(build_model(cfg, state_dict, device, train=True), **options)
    else:
        dp = axis_size(mesh, "dp")
        if args.batch % dp:
            ap.error(f"--batch {args.batch} must divide by dp={dp}")
        model = build_model(cfg, shard_state_dict(state_dict, mesh), device, train=True,
                            tp_group=axis_group(mesh, "tp"))
        step_fn = ShardedTrainStep(model, mesh, **options)
        say(f"{args.num_processes} ranks, mesh {mesh}")

    def save(path) -> None:
        state = step_fn.checkpoint_state()  # every rank: gathered over a mesh
        if lead:
            write_train_state(path, state)

    start = 0
    if args.resume:
        start = load_train_state(args.ckpt, step_fn)
        say(f"resumed at step {start}")
    if start >= args.steps:
        say(f"nothing to do: resumed step {start} >= --steps {args.steps}; "
            "checkpoint left untouched")
        return 0
    K = args.steps_per_call
    if (args.steps - start) % K:
        ap.error(f"--steps-per-call {K} must divide the remaining steps "
                 f"({args.steps} - resumed {start})")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    loss = float("nan")
    t_log, last_logged = time.monotonic(), start
    step = start
    while step < args.steps:
        stems = torch.from_numpy(np.stack([sampler.batch(args.batch)
                                           for _ in range(K)])).to(device)
        augs = [draw_augmentation(stems.shape[1:], gen) for _ in range(K)]
        loss_dev = augmented_steps(step_fn, stems, augs)[-1]
        step += K
        if step % args.log_every < K or step == args.steps:
            loss = float(loss_dev)  # a host fetch: waits for the steps
            now = time.monotonic()
            step_s = (now - t_log) / (step - last_logged)
            t_log, last_logged = now, step
            say(f"step {step}/{args.steps}  loss {loss:.6f}  step_s {step_s:.4f}  "
                f"{args.batch * seg / SAMPLE_RATE / step_s:.2f} audio-s/s")
        if evaluate is not None and step % args.eval_every < K:
            loss_dev.item()  # the steps' device work ends before the eval's clock starts
            t0 = time.monotonic()
            evaluate(step_fn, step)
            t_log += time.monotonic() - t0  # step_s times the training alone
        if args.ckpt and step % args.save_every == 0 and step != args.steps:
            loss_dev.item()
            t0 = time.monotonic()
            save(args.ckpt)
            secs = time.monotonic() - t0
            t_log += secs
            say(f"checkpointed at step {step} ({secs:.2f} s)")
    if evaluate is not None and args.steps % args.eval_every:
        evaluate(step_fn, args.steps)  # close the curve at the final step
    if args.ckpt:
        save(args.ckpt)
        say(f"final checkpoint at {args.ckpt}")
        if evaluate is not None and evaluate.best["step"] >= 0:
            say(f"best eval l1 {evaluate.best['l1']:.5f} at step "
                f"{evaluate.best['step']} -> {args.ckpt}.best")

    if args.export_ggml:
        weights = step_fn.export_weights()  # every rank: gathered over a mesh
        if lead:
            flat = {k: v.detach().cpu().numpy() for k, v in weights.items()}
            P.write_ggml(args.export_ggml, GGML_KIND[family], flat)
            which = "EMA" if args.ema is not None else "trained"
            say(f"exported {which} weights -> {args.export_ggml} ({GGML_KIND[family]})")
    if lead:
        print(f"done: final loss {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

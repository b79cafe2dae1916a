"""In-process serving API: the port of `demucs_tpu/serving.py`.

A session loads a ggml weight file (a path or its bytes) once and keeps
the model resident on its device; each call separates one segment, one
track or several tracks, and progress flows through the
`ProgressCallback` hook. The HTTP server (`tools/serve.py`) and the
feeder (`service.DeviceFeeder`) are built on it.

The dtype: the JAX package serves in bf16 by default on a TPU, a choice
that rests on a TPU measurement. Here the default is f32 on both
devices; `dtype=torch.bfloat16` runs the bf16 network of `--bf16`
(`params.cast_state_dict`). The device is "cuda" unless the caller asks
for "cpu"; a CUDA session without a GPU raises.

The export (`export_program`, `export_track_program`) is `torch.export`
of the segment graph or of one bucket's fused whole-track pass,
serialized with `torch.export.save`. The kernels are custom ops
(`torch.ops.demucs_tpu_torch.*`), so the exported graph calls them; the
program holds its weights, so it is called as `fn(mix)` and
`fn(track, n_true)`, where the JAX artifact takes the parameters as its
first argument. Loading one needs torch and the op registry
(`demucs_tpu_torch.ops.cuda`), not the model code.
"""

from __future__ import annotations

import dataclasses
import io
import math
from pathlib import Path

import numpy as np
import torch
from torch import nn

from . import config as C
from .models import build_bag, build_model
from .params import cast_state_dict, load_model_params
from .pipeline import ApplyOptions, Separator
from .utils.device import f32_precision, resolve_device
from .utils.progress import ProgressCallback, null_progress


def _state_dict_in(state_dict: dict, dtype) -> dict:
    if dtype in (None, torch.float32):
        return state_dict
    if dtype != torch.bfloat16:
        raise ValueError(f"a session runs in torch.float32 or torch.bfloat16, not {dtype}")
    return cast_state_dict(state_dict, dtype)


class _SegmentProgram(nn.Module):
    """The segment graph as export traces it: mix (B, 2, L) -> (B, S, 2, L)
    f32."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        return self.model(mix).float()


class ExportedProgram(nn.Module):
    """A loaded exported program, called inside `f32_precision()`: the
    live model turns TF32 off through torch's process-wide flags, which
    are not part of an exported graph, so without this scope the
    program's cuDNN convolutions would run in TF32 under torch's default
    flags. `graph` is the program's graph."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self.program = program

    @property
    def graph(self):
        return self.program.graph

    def forward(self, *args):
        with f32_precision():
            return self.program(*args)


def _export(module: nn.Module, args: tuple) -> bytes:
    """torch.export of module on args (no grad), serialized to bytes.
    Runs it once first: the model's constants (windows, embeddings) are
    uploaded on their first real call and cached, which must not happen
    under export's fake tensors."""
    with torch.no_grad():
        module(*args)
        exported = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


class DemixSession:
    """A resident separation session (the JAX class of the same name, the
    reference's `modelInit`, src_wasm/demucs.cpp:70-84).

    model: a ggml weight file's path or bytes; the family (htdemucs-4s/6s
    or hdemucs_mmi) comes from its magic. dtype: None or torch.float32
    (the default on both devices) or torch.bfloat16 (the bf16 network of
    `--bf16`). device: "cuda" (default; raises without a GPU) or "cpu".
    """

    def __init__(self, model: str | Path | bytes, dtype=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg, state_dict = load_model_params(model)
        self.model = build_model(self.cfg, _state_dict_in(state_dict, dtype), self.device).eval()
        self._separators: dict = {}  # ApplyOptions snapshot -> Separator

    @property
    def sources(self) -> tuple[str, ...]:
        return self.cfg.sources

    def demix_segment(self, left: np.ndarray, right: np.ndarray,
                      ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """One segment, no overlap-add (the reference's
        `modelDemixSegment`, src_wasm/demucs.cpp:86-171): (L,), (R,) ->
        {stem: (L, R)}."""
        mix = torch.from_numpy(np.stack([left, right])[None].astype(np.float32))
        with torch.inference_mode():
            out = self.model(mix.to(self.device)).float().cpu().numpy()[0]  # (S, 2, N)
        return {name: (out[i, 0], out[i, 1]) for i, name in enumerate(self.cfg.sources)}

    def _separator(self, options: ApplyOptions | None) -> Separator:
        """One Separator per distinct options, so repeated demix_track
        calls reuse its staging buffers and fused plans."""
        opts = options or ApplyOptions()
        key = tuple(v if isinstance(v, (int, float, str, type(None), bool)) else str(v)
                    for v in dataclasses.astuple(opts))
        if key not in self._separators:
            self._separators[key] = Separator(self.model, self.cfg.num_sources, opts,
                                              self.device)
        return self._separators[key]

    def demix_track(self, audio: np.ndarray,
                    options: ApplyOptions | None = None,
                    progress: ProgressCallback = null_progress) -> np.ndarray:
        """A whole track with overlap-add: (2, N) -> (S, 2, N)."""
        return self._separator(options)(audio, progress=progress)

    def demix_tracks(self, tracks: list[np.ndarray],
                     options: ApplyOptions | None = None,
                     progress: ProgressCallback = null_progress
                     ) -> list[np.ndarray]:
        """Several tracks in one global segment batch
        (`pipeline.Separator.separate_many`)."""
        return self._separator(options).separate_many(tracks, progress=progress)

    def export_program(self, batch_size: int = 8,
                       segment_samples: int | None = None) -> bytes:
        """The segment graph for mix (batch_size, 2, segment_samples) f32,
        exported with `torch.export` and serialized: the bytes load with
        `load_exported` into fn(mix) -> (batch_size, S, 2, segment_samples)
        f32 on this session's device. The program holds its weights (the
        JAX artifact takes them as an argument) and calls the kernels as
        `demucs_tpu_torch::` custom ops."""
        seg = segment_samples or C.SEGMENT_SAMPLES
        mix = torch.zeros(batch_size, 2, seg, device=self.device)
        return _export(_SegmentProgram(self.model), (mix,))

    def export_track_program(self, track_samples: int, batch_size: int = 8,
                             segment_samples: int | None = None) -> bytes:
        """The fused whole-track pass (split, segment graph and weighted
        overlap-add all on the device), exported and serialized: the live
        pass's own program for the bucket (`pipeline.FusedTrackProgram`,
        which the session's Separator caches).

        It loads into fn(track (2, Lp) f32, n_true 0-d int tensor) ->
        (S, 2, Lp) stems of the normalized track, where Lp =
        ceil(track_samples / stride) * stride, exact for any true length
        n_true in (Lp - stride, Lp]. The caller normalizes by the track's
        mono mean and std, pads with zeros to Lp, slices [:n_true] and
        denormalizes: on the host as `pipeline.Separator._normalize_shift`
        does, or on the device as the live fused pass does
        (`Separator._normalize_pad`, then the slice and affine map in
        `_fused_dispatch`). The shift trick is off,
        so the program is deterministic and self-contained. The program
        holds its weights (the JAX artifact takes them as an argument)."""
        opts = ApplyOptions(batch_size=batch_size, fused_track=True, max_shift_secs=0.0,
                            shift_offset=0).with_segment(segment_samples)
        sep = self._separator(opts)
        stride = int((1 - sep.options.overlap) * sep.options.segment_samples)
        n_seg = max(1, math.ceil(track_samples / stride))
        Lp = n_seg * stride
        x = torch.zeros(2, Lp, device=self.device)
        return _export(sep._fused_track_fn(n_seg, Lp),
                       (x, torch.tensor(Lp, device=self.device)))

    @staticmethod
    def load_exported(blob: bytes) -> ExportedProgram:
        """An `export_program` / `export_track_program` artifact -> the
        callable program (fn(mix), fn(track, n_true)), which computes in
        f32 (TF32 off) whatever torch's global flags say, as the live
        session does. Its custom ops are registered by importing
        `demucs_tpu_torch.ops.cuda` (this module does, through the
        models)."""
        return ExportedProgram(torch.export.load(io.BytesIO(blob)).module())


class BagDemixSession(DemixSession):
    """A resident session of the fine-tuned bag (the reference's premium
    configuration, cli-apps/demucs_ft.cpp:136-241): the four
    htdemucs_ft_* files of `ft_dir` (`cli._find_ft_models`), model i's
    stem i kept (`models.BagOfModels`), served through the same surface as
    `DemixSession`, so the HTTP server, the feeder and the streams run the
    bag unchanged. dtype and device as `DemixSession`'s."""

    def __init__(self, ft_dir: str | Path, dtype=None,
                 device: str | torch.device = "cuda"):
        from .cli import _find_ft_models

        self.device = resolve_device(device)
        loaded = [load_model_params(p) for p in _find_ft_models(Path(ft_dir))]
        self.cfg = loaded[0][0]
        self.model = build_bag(self.cfg, [_state_dict_in(sd, dtype) for _, sd in loaded],
                               self.device).eval()
        self._separators = {}

"""demucs_tpu_torch's host side of the track path against demucs_tpu on
the CPU: pipelined batches, int16 stem transfers, the fused whole-track
path and its buckets, multi-track batching, intra-segment stage marks,
the stage timer and the CLI's new flags and directory input.

The cases of tests/test_pipeline.py, run through both packages on the
same numpy input. Tolerances:
  * depth 1 against depth 2 or 3, and the fused path's reruns: bit for
    bit (only the interleaving of launches and fetches changes);
  * port against JAX, f32: rtol 1e-5, atol 1e-6, as
    tests/test_torch_pipeline.py (the two differ in the order of sums);
  * with int16 transfers, port against JAX: one quantization step
    (1 / PCM16_TRANSFER_SCALE in the normalized domain) x max(std, 1),
    since a value on a rounding boundary may round either way;
  * fused against batched: atol 3e-5, as tests/test_pipeline.py (the
    fused overlap-add sums in f32, the host's in f64).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from demucs_tpu import audio as JAud
from demucs_tpu import params as JP
from demucs_tpu import pipeline as JPipe
from demucs_tpu.cli import main as jax_main
from demucs_tpu.config import HDEMUCS_V3 as JV3
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.models import hdemucs_v3_segment, htdemucs_segment
from demucs_tpu.utils.profiling import StageTimer as JaxStageTimer

from demucs_tpu_torch import audio as TAud
from demucs_tpu_torch import pipeline as TPipe
from demucs_tpu_torch.cli import main as torch_main
from demucs_tpu_torch.config import HDEMUCS_V3, HTDEMUCS_4S
from demucs_tpu_torch.models import build_hdemucs_v3, build_htdemucs
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.utils.profiling import StageTimer, fence

from _torch_threads import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
FUSED_ATOL = 3e-5
STEP = 1.0 / TPipe.PCM16_TRANSFER_SCALE


class _Stems(torch.nn.Module):
    """(B, C, L) -> (B, 3, C, L): three nonlinear "sources"."""

    def forward(self, mix):
        return torch.stack([mix, 2.0 * mix, torch.tanh(mix)], dim=1)


def _jax_stems(params, mix):
    return jnp.stack([mix, 2.0 * mix, jnp.tanh(mix)], axis=1)


class _Identity(torch.nn.Module):
    """tests/test_pipeline.py's _identity_model: (mix, 2 mix, mix)."""

    def forward(self, mix):
        return torch.stack([mix, mix * 2.0, mix], dim=1)


def _jax_identity(params, mix):
    return jnp.stack([mix, mix * 2.0, mix], axis=1)


class _Positional(torch.nn.Module):
    """tests/test_pipeline.py's _positional_model: each stem delays the
    input and scales it by a ramp over the position inside the segment,
    so a tail segment placed anywhere but where split_into_segments puts
    it changes the output."""

    def forward(self, mix):
        T = mix.shape[-1]
        ramp = 0.5 + torch.arange(T, dtype=torch.float32) / (2 * T)
        return torch.stack([F.pad(mix, (s * 7 + 3, 0))[:, :, :T] * ramp
                            for s in range(3)], dim=1)


def _jax_positional(params, mix):
    T = mix.shape[-1]
    ramp = 0.5 + jnp.arange(T, dtype=jnp.float32) / (2 * T)
    return jnp.stack([jnp.pad(mix, ((0, 0), (0, 0), (s * 7 + 3, 0)))[:, :, :T] * ramp
                      for s in range(3)], axis=1)


def _port(model, **kw):
    return TPipe.Separator(model, 3, TPipe.ApplyOptions(**kw), device="cpu")


def _jax(fn, **kw):
    return JPipe.Separator(fn, {}, 3, JPipe.ApplyOptions(**kw))


def _track(seed, n, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, n)) * scale).astype(np.float32)


# --- pipelining ----------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_is_bit_identical_to_serial_and_matches_jax(depth):
    """pipeline_depth > 1 changes only how launches and fetches
    interleave: bit-identical to depth 1, and equal to JAX's pipelined
    separator at the same depth."""
    audio = _track(7, 40000)
    kw = dict(segment_samples=4096, batch_size=2, shift_offset=33, max_shift_secs=0.02)
    serial = _port(_Positional(), pipeline_depth=1, **kw)(audio)
    piped = _port(_Positional(), pipeline_depth=depth, **kw)(audio)
    np.testing.assert_array_equal(piped, serial)
    ref = _jax(_jax_positional, pipeline_depth=depth, **kw)(audio)
    np.testing.assert_allclose(piped, ref, rtol=RTOL, atol=ATOL)


def test_default_options_match_jax():
    ours, ref = TPipe.ApplyOptions(), JPipe.ApplyOptions()
    for field in ("fine_progress", "transfer_int16", "pipeline_depth", "fused_track",
                  "fused_buckets", "fused_sub_batch", "batch_size"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.pipeline_depth == 2
    assert TPipe.PCM16_TRANSFER_SCALE == JPipe.PCM16_TRANSFER_SCALE


# --- int16 transfers --------------------------------------------------------

def test_int16_transfer_matches_jax_and_stays_in_budget():
    """transfer_int16 quantizes the stems on the device: the port's int16
    result is within one quantization step of JAX's, and holds the JAX
    test's budget against its own f32 result."""
    audio = _track(8, 30000)
    kw = dict(segment_samples=4096, batch_size=4, shift_offset=0)
    exact = _port(_Identity(), **kw)(audio)
    quant = _port(_Identity(), transfer_int16=True, **kw)(audio)
    ref = _jax(_jax_identity, transfer_int16=True, **kw)(audio)
    std = audio.mean(0).std(ddof=1)
    np.testing.assert_allclose(quant, ref, rtol=0, atol=STEP * max(std, 1.0))
    # the JAX test's assertions (tests/test_pipeline.py)
    atol = 2.0 * STEP * max(std, 1.0)
    np.testing.assert_allclose(quant[0], exact[0], atol=atol)
    np.testing.assert_allclose(quant[2], exact[2], atol=atol)
    err1 = np.abs(quant[1] - exact[1])
    assert (err1 > atol).mean() < 0.02
    assert err1[np.abs(exact[1]) < 7.5 * std].max() <= atol
    assert np.abs(quant[0] - audio).max() < 1e-3


def test_encode_int16_rounds_half_to_even_and_clips():
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 1e6, -1e6]) / TPipe.PCM16_TRANSFER_SCALE
    q = TPipe.encode_int16(y)
    assert q.dtype == torch.int16
    assert q.tolist() == [0, 2, 2, 0, -2, 32767, -32768]
    ref = jnp.clip(jnp.round(jnp.asarray(y.numpy()) * JPipe.PCM16_TRANSFER_SCALE),
                   -32768.0, 32767.0).astype(jnp.int16)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref))


# --- the fused whole-track path --------------------------------------------

@pytest.mark.parametrize("n", [50011, 3072 * 5 + 1, 9000])
def test_fused_track_tail_exact_with_positional_model(n):
    """The fused pass reproduces the batched path's tail placement at a
    length mid-stride, just past a stride boundary and below two
    segments, with a model that cares about absolute position; a rerun
    is bit-identical."""
    audio = _track(11 + n, n)
    kw = dict(segment_samples=4096, batch_size=4, shift_offset=17, max_shift_secs=0.02)
    batched = _port(_Positional(), **kw)(audio)
    sep = _port(_Positional(), fused_track=True, **kw)
    fused = sep(audio)
    assert fused.shape == batched.shape == (3, 2, n)
    np.testing.assert_allclose(fused, batched, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_array_equal(sep(audio), fused)
    ref = _jax(_jax_positional, fused_track=True, **kw)(audio)
    np.testing.assert_allclose(fused, ref, rtol=RTOL, atol=ATOL)


def test_fused_track_int16_and_many():
    """fused + transfer_int16 through separate_many: two tracks of one
    length share one plan, and each stays within the JAX test's budget
    of the exact batched result."""
    tracks = [_track(10, 30000), _track(11, 30000, 0.2)]
    kw = dict(segment_samples=4096, batch_size=4, shift_offset=0)
    exact = _port(_Identity(), **kw)
    fused = _port(_Identity(), fused_track=True, transfer_int16=True, **kw)
    outs = fused.separate_many(tracks)
    assert len(fused._fused_cache) == 1
    for t, o in zip(tracks, outs):
        ref = exact(t)
        std = t.mean(0).std(ddof=1)
        np.testing.assert_allclose(o[0], ref[0], atol=3e-4 * max(std, 1.0))
        np.testing.assert_allclose(o[2], ref[2], atol=3e-4 * max(std, 1.0))


def test_fused_geo_buckets_exact_and_fewer_plans():
    """fused_buckets='geo': six lengths share three plans (segment-count
    buckets 3, 4 and 12), and each result matches the batched path; an
    LRU cap of 2 keeps the two most recent."""
    kw = dict(segment_samples=4096, batch_size=4, shift_offset=0, max_shift_secs=0.0)
    geo = _port(_Positional(), fused_track=True, fused_buckets="geo", **kw)
    for n in (9000, 9500, 10000, 30000, 31000, 33000):
        audio = _track(12 + n, n)
        np.testing.assert_allclose(geo(audio), _port(_Positional(), **kw)(audio),
                                   rtol=0, atol=FUSED_ATOL, err_msg=f"n={n}")
    assert len(geo._fused_cache) == 3, list(geo._fused_cache)
    assert [k[0] for k in geo._fused_cache] == [3, 4, 12]
    capped = _port(_Positional(), fused_track=True, fused_buckets="geo", **kw)
    capped.fused_cache_limit = 2
    for n in (9000, 10000, 30000, 9000):
        capped(_track(0, n))
    assert [k[0] for k in capped._fused_cache] == [12, 3]
    with pytest.raises(ValueError, match="fused_buckets"):
        _port(_Positional(), fused_track=True, fused_buckets="nope", **kw)(_track(0, 9000))


def test_fused_sub_batch_groups_the_model_calls():
    """The fused pass calls the model on groups of fused_sub_batch
    segments (auto: min(2, batch_size)), as many groups as the batched
    path at that batch size has batches."""
    calls = []

    class Counting(_Stems):
        def forward(self, mix):
            calls.append(mix.shape[0])
            return super().forward(mix)

    audio = _track(3, 31000)
    kw = dict(segment_samples=4096, batch_size=8, shift_offset=0, max_shift_secs=0.0)
    _port(Counting(), fused_track=True, **kw)(audio)
    assert calls == [2] * 5 + [1]            # 11 segments, auto sub-batch 2
    calls.clear()
    _port(Counting(), fused_track=True, fused_sub_batch=4, **kw)(audio)
    assert calls == [4, 4, 3]


def test_fused_track_with_fine_progress_raises():
    kw = dict(fused_track=True, fine_progress=True)
    with pytest.raises(ValueError, match="fine_progress"):
        _port(_Stems(), **kw)
    with pytest.raises(ValueError, match="fine_progress"):
        _jax(_jax_stems, **kw)


# --- the fused path's normalize and denormalize on the device ------------

SEG, STRIDE, MAX_SHIFT = 256, 192, 44   # max_shift_secs 0.001 at 44.1 kHz


def _host_prepared(sep, audio):
    """`_normalize_shift` and the zero pad to the bucket's length: what
    the fused pass took as input when the host normalized."""
    shifted, (_, _, _, ref_mean, ref_std) = sep._normalize_shift(audio, TPipe.null_progress)
    n_true = shifted.shape[-1]
    n_seg, prev_b = sep._bucket_nseg(-(-n_true // STRIDE))
    padded = np.pad(shifted, ((0, 0), (0, n_seg * STRIDE - n_true)))
    return padded, n_true, n_seg, prev_b, ref_mean, ref_std


@pytest.mark.parametrize("case", [
    # (n_true, shift_offset, max_shift_secs, track): n_true 768 closes a
    # bucket of 4 strides, 769 opens the next
    (768, 0, 0.001, "noise"), (769, 0, 0.001, "noise"),
    (768, MAX_SHIFT - 1, 0.001, "noise"), (769, MAX_SHIFT - 1, 0.001, "noise"),
    (768, None, 0.0, "noise"), (769, None, 0.0, "noise"),
    (769, 5, 0.001, "silent"), (768, 5, 0.001, "float64")])
def test_fused_device_prepare_matches_host_normalize_shift_pad(case):
    """The fused path's prepare, normalized on the device from the raw
    upload, is the host's `_normalize_shift` then the pad, to f32
    rounding (the stats sum in another order), with zeros exactly outside
    the track; its stats are the host's, and the plan the same bucket's."""
    n_true, offset, shift_secs, kind = case
    sep = _port(_Stems(), segment_samples=SEG, fused_track=True, shift_offset=offset,
                max_shift_secs=shift_secs)
    max_shift = int(shift_secs * 44100)
    assert max_shift == (MAX_SHIFT if shift_secs else 0)
    start = max_shift - (offset or 0)
    N = n_true - start
    audio = {"noise": _track(31, N, 0.3) + 0.05,
             "silent": np.zeros((2, N), np.float32),
             "float64": np.random.default_rng(32).standard_normal((2, N)) * 0.3}[kind]
    want, want_n, n_seg, prev_b, ref_mean, ref_std = _host_prepared(sep, audio)
    fn, placed, got_n, (got_seg, got_start, got_N, mean, std) = sep._fused_prepare(audio)
    assert want_n == n_true
    assert (got_n, got_seg, got_start, got_N) == (n_true, n_seg, start, N)
    assert fn is sep._fused_track_fn(n_seg, n_seg * STRIDE, min_n=prev_b * STRIDE + 1)
    got = placed.numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert not got[:, :start].any() and not got[:, start + N:].any()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * max(np.abs(want).max(), 1))
    np.testing.assert_allclose(float(mean), float(ref_mean), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(std), float(ref_std), rtol=1e-6, atol=0)
    assert mean.dtype == std.dtype == torch.from_numpy(audio).dtype


def _int16_host_form(sep, audio):
    """The fused int16 pass as the host encoded it: `_normalize_shift`,
    the pad and the int16 encode on the host, the pass, the int16 stems
    decoded, un-shifted and denormalized on the host."""
    padded, n_true, n_seg, prev_b, ref_mean, ref_std = _host_prepared(sep, audio)
    fn = sep._fused_track_fn(n_seg, n_seg * STRIDE, min_n=prev_b * STRIDE + 1)
    up = np.clip(np.round(padded * TPipe.PCM16_TRANSFER_SCALE), -32768, 32767).astype(np.int16)
    with torch.inference_mode():
        y = fn(torch.from_numpy(up).float() / TPipe.PCM16_TRANSFER_SCALE, torch.tensor(n_true))
        q = TPipe.encode_int16(y).numpy()
    start = n_true - audio.shape[-1]
    stems = (q.astype(np.float32) / TPipe.PCM16_TRANSFER_SCALE)[:, :, start:]
    return stems[:, :, :audio.shape[-1]] * ref_std + ref_mean


@pytest.mark.parametrize("int16", [False, True])
def test_fused_many_spans_and_device_norm_count(int16):
    """A fused separate_many of 3 tracks under tracing: each track has its
    track.prepare, .place and .finish, and device_norm_tracks counts the
    tracks normalized on the device: 3 in f32, 0 with transfer_int16,
    whose result is the host-encode form's bit for bit. The f32 result
    matches the batched path."""
    from demucs_tpu_torch.utils import profiling

    tracks = [_track(40, 700), _track(41, 1000, 0.2) - 0.1, _track(42, 700, 0.5)]
    kw = dict(segment_samples=SEG, batch_size=2, shift_offset=7, max_shift_secs=0.001)
    sep = _port(_Positional(), fused_track=True, transfer_int16=int16, **kw)
    profiling.reset()
    try:
        with profiling.tracing():
            outs = sep.separate_many(tracks)
        recs, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.reset()
    (root,) = [r for r in recs if r["parent"] is None]
    for name in ("track.prepare", "track.place", "track.finish"):
        mine = [r for r in recs if r["name"] == name]
        assert len({r["request"] for r in mine}) == len(mine) == 3, name
    assert root["counts"].get("device_norm_tracks", 0) == counters.get(
        "device_norm_tracks", 0) == (0 if int16 else 3)
    batched = _port(_Positional(), **kw)
    for t, o in zip(tracks, outs):
        assert o.shape == (3, 2, t.shape[-1]) and o.dtype == np.float32
        if int16:
            np.testing.assert_array_equal(o, _int16_host_form(sep, t))
        else:
            np.testing.assert_allclose(o, batched(t), rtol=0, atol=FUSED_ATOL)


@pytest.mark.parametrize("int16", [False, True])
def test_fused_results_do_not_share_the_host_buffers(int16):
    """The fused path's stems own their memory: no returned array is a
    view of a result buffer (`_host_buffer`) or of the input."""
    tracks = [_track(50, 900), _track(51, 1300)]
    sep = _port(_Stems(), segment_samples=SEG, fused_track=True, transfer_int16=int16,
                shift_offset=0, max_shift_secs=0.0)
    buffers = []
    make = sep._host_buffer

    def recording(shape, dtype):
        buffers.append(make(shape, dtype))
        return buffers[-1]

    sep._host_buffer = recording
    outs = sep.separate_many(tracks) + [sep(tracks[0])]
    assert len(buffers) == 3
    for o in outs:
        for b in [b.numpy() for b in buffers] + tracks:
            assert not np.shares_memory(o, b)
    np.testing.assert_array_equal(outs[0], outs[2])


# --- multi-track batching -------------------------------------------------

def test_separate_many_matches_jax_and_single_calls():
    tracks = [_track(3, 15000), _track(4, 8011, 0.2), _track(5, 22222, 0.4)]
    kw = dict(segment_samples=4096, batch_size=4, shift_offset=100, max_shift_secs=0.02)
    sep = _port(_Stems(), **kw)
    many = sep.separate_many(tracks)
    ref = _jax(_jax_stems, **kw).separate_many(tracks)
    assert len(many) == len(ref) == 3
    for m, r, t in zip(many, ref, tracks):
        assert m.shape == (3,) + t.shape
        np.testing.assert_allclose(m, r, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(m, sep(t), rtol=0, atol=1e-5)


# --- stage marks and the stage timer ----------------------------------------

def _program_order(events):
    """JAX's stage marks are unordered debug callbacks: the compiled
    program may report them in another order than the graph's. Put each
    batch's stage marks (those between two batch reports) in the graph's
    order, by fraction."""
    out, block = [], []
    for ev in events:
        if ev[1].startswith(("segments", "apply model")):
            out += sorted(block, key=lambda e: e[0]) + [ev]
            block = []
        else:
            block.append(ev)
    return out + sorted(block, key=lambda e: e[0])


@pytest.mark.parametrize("family", ["htdemucs", "hdemucs_v3"])
def test_fine_progress_stage_marks_match_jax(family):
    """A narrow htdemucs-4s (2 device calls) and hdemucs_mmi (1 call) with
    fine_progress report the JAX package's (fraction, message) sequence:
    26 stage marks per v4 call, 22 per v3 call, and the batch reports."""
    if family == "htdemucs":
        jcfg = dataclasses.replace(J4S, channels=8, bottom_channels=32)
        tcfg = dataclasses.replace(HTDEMUCS_4S, channels=8, bottom_channels=32)
        flat = JP.init_flat(JP.htdemucs_schema(jcfg), seed=0)
        model = build_htdemucs(tcfg, from_jax_params(flat), "cpu")
        fn, n, per_call, calls = (lambda p, m: htdemucs_segment(p, m, jcfg)), 20000, 26, 2
    else:
        flat = JP.init_flat(JP.hdemucs_v3_schema(JV3), seed=0)
        model = build_hdemucs_v3(HDEMUCS_V3, from_jax_params(flat), "cpu")
        fn, n, per_call, calls = (lambda p, m: hdemucs_v3_segment(p, m, JV3)), 9000, 22, 1
    kw = dict(segment_samples=8192, batch_size=2, shift_offset=0, max_shift_secs=0.01,
              fine_progress=True)
    audio = _track(5, n, 0.1)
    ours, ref = [], []
    TPipe.Separator(model, 4, TPipe.ApplyOptions(**kw), device="cpu")(
        audio, progress=lambda f, m: ours.append((f, m)))
    JPipe.Separator(fn, JP.unflatten_tree(flat), 4, JPipe.ApplyOptions(**kw))(
        audio, progress=lambda f, m: ref.append((f, m)))
    assert ours == _program_order(ref)
    stages = [m for _, m in ours if not m.startswith(("segments", "apply model"))]
    assert len(stages) == per_call * calls
    assert [m for _, m in ours if m.startswith("segments")] == \
        [f"segments {min(2 * (i + 1), calls * 2)}/{calls * 2}" for i in range(calls)]
    fracs = [f for f, _ in ours]
    assert fracs == sorted(fracs) and fracs[-1] == 1.0


def test_stage_marks_are_off_by_default():
    """Without fine_progress the model reports nothing but batches, and a
    mark outside stage_tracing() reaches no sink."""
    from demucs_tpu_torch.utils.progress import report_stage, stage_sink

    got = []
    with stage_sink(lambda f, m: got.append(m)):
        report_stage(0.5, "ignored")
    assert got == []
    events = []
    _port(_Stems(), segment_samples=4096, batch_size=2, shift_offset=0)(
        _track(1, 9000), progress=lambda f, m: events.append(m))
    assert all(m.startswith(("segments", "apply model")) for m in events)


def test_stage_timer_report_has_the_jax_shape():
    audio = _track(4, 9000)
    kw = dict(segment_samples=4096, batch_size=2, shift_offset=0)
    ours, ref = StageTimer(), JaxStageTimer()
    _port(_Stems(), **kw)(audio, progress=ours)
    _jax(_jax_stems, **kw)(audio, progress=ref)
    lines = [json.loads(x) for x in ours.report().splitlines()]
    ref_lines = [json.loads(x) for x in ref.report().splitlines()]
    assert [set(x) for x in lines] == [set(x) for x in ref_lines]
    assert [x["message"] for x in lines] == [x["message"] for x in ref_lines]
    assert [x["fraction"] for x in lines] == [x["fraction"] for x in ref_lines]
    assert all(x["stage_s"] >= 0 for x in lines)
    assert fence(torch.zeros(1)) >= 0.0


# --- CLI ---------------------------------------------------------------------

def test_cli_directory_fused_int16_matches_jax_cli(tmp_path):
    """Both CLIs on a directory of two WAVs with --fused --transfer-int16
    (htdemucs-4s at full width, 16384-sample segments, pinned shift):
    one folder of stems per track, the same files, within one
    quantization step of each other."""
    model = tmp_path / "model.bin"
    JP.write_ggml(model, "htdemucs_4s", JP.init_flat(JP.htdemucs_schema(J4S), seed=0))
    tracks = tmp_path / "tracks"
    tracks.mkdir()
    inputs = {"b_second": _track(21, 21000, 0.2), "a_first": _track(20, 20000, 0.25)}
    for name, x in inputs.items():
        JAud.write_wav(tracks / f"{name}.wav", x)
    (tracks / "notes.txt").write_text("not a track")
    common = ["--offset", "1337", "--batch", "2", "--segment-samples", "16384",
              "--fused", "--transfer-int16"]
    assert torch_main([str(model), str(tracks), str(tmp_path / "port"),
                       "--device", "cpu", "--pipeline-depth", "2"] + common) == 0
    assert jax_main([str(model), str(tracks), str(tmp_path / "jax"), "--no-mesh"]
                    + common) == 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["a_first", "b_second"]
    for name, x in inputs.items():
        std = x.mean(0).std(ddof=1)
        for i, stem in enumerate(J4S.sources):
            f = f"{name}/target_{i}_{stem}.wav"
            ours, rate = TAud.read_wav(tmp_path / "port" / f)
            ref, _ = TAud.read_wav(tmp_path / "jax" / f)
            assert rate == 44100 and ours.shape == ref.shape == x.shape
            assert np.isfinite(ours).all()
            err = np.abs(ours - ref).max()
            assert err <= STEP * max(std, 1.0), (f, err)


def test_cli_rejects_an_empty_directory(tmp_path):
    (tmp_path / "empty").mkdir()
    assert torch_main(["m.bin", str(tmp_path / "empty"), str(tmp_path / "o"),
                       "--device", "cpu"]) == 1


_NO_JAX_RUN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "demucs_tpu"):
            raise ImportError(f"demucs_tpu_torch imported {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np, torch
from demucs_tpu_torch.pipeline import ApplyOptions, Separator
from demucs_tpu_torch.utils import profiling

class Stems(torch.nn.Module):
    def forward(self, mix):
        return torch.stack([mix, 2 * mix], 1)

x = np.random.default_rng(0).standard_normal((2, 9000)).astype(np.float32)
for kw in (dict(fine_progress=True), dict(fused_track=True, transfer_int16=True)):
    opts = ApplyOptions(segment_samples=4096, batch_size=2, shift_offset=0, **kw)
    timer = profiling.StageTimer()
    with profiling.trace(sys.argv[1]):
        Separator(Stems(), 2, opts, device="cpu").separate_many([x, x], progress=timer)
    timer.report()
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "demucs_tpu")))
"""


def test_host_path_runs_without_jax(tmp_path):
    """The pipelined, fine-progress, fused and int16 paths, the stage
    timer and the profiler trace run with jax and demucs_tpu blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_RUN, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    assert (tmp_path / "trace.json").stat().st_size > 0

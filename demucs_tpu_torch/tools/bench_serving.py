"""A load generator for the serving paths: the port of
`demucs_tpu/tools/bench_serving.py`.

Runs full-width htdemucs-4s (random weights from seed 0) and prints one
JSON line per mode:
  * separate_many: --tracks tracks of --track-secs seconds in one global
    segment batch (normalize, shift, split, overlap-add on the host
    included), after one warm call;
  * single_track: one of them alone (what one user waits for);
  * streaming_1s_pushes: every track pushed 1 s at a time through
    `streaming.StreamingSeparator`;
  * with --http, http_request: one upload to the server
    (`tools/serve.py`, fused by default) after a warm one;
  * with --concurrent N, http_concurrent: N uploads to a non-fused server
    one after another, then all at once, whose segments share the
    feeder's batches; serial against concurrent wall time and the
    feeder's device calls.

It writes nothing else (no BENCHMARK.json). The device is the GPU unless
--device cpu is given; without a GPU a CUDA run fails.

Usage:
    python -m demucs_tpu_torch.tools.bench_serving [--tracks 4]
        [--track-secs 30] [--http] [--concurrent N] [--batch 8]
        [--f32-transfer] [--pipeline-depth 2] [--fused] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import threading
import time
import urllib.request
import zipfile

import numpy as np


def _server(model_path: str, args, **kw):
    """A started server on a free port -> (server, base URL)."""
    from .serve import make_server

    srv = make_server(model_path, port=0, batch=args.batch, device=args.device, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv) -> None:
    srv.shutdown()
    srv.server_close()
    srv.feeder.close()


def _post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(f"{url}/separate", data=body,
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=4)
    ap.add_argument("--track-secs", type=float, default=30.0)
    ap.add_argument("--http", action="store_true", help="also time the HTTP server path")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--f32-transfer", action="store_true",
                    help="bit-exact f32 stem transfers (default: int16 encoded on "
                         "the device, half the bytes)")
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--fused", action="store_true",
                    help="the fused whole-track pass (split and overlap-add on the "
                         "device; one upload and one download per track)")
    ap.add_argument("--concurrent", type=int, default=0,
                    help="N: also time N simultaneous uploads to a non-fused "
                         "server, whose segments share the feeder's batches")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default; fails without one) or the CPU")
    args = ap.parse_args(argv)

    import torch

    from .. import audio as A
    from .. import params as P
    from ..config import HTDEMUCS_4S
    from ..models import build_model
    from ..pipeline import ApplyOptions, Separator
    from ..streaming import StreamingSeparator
    from ..utils.device import resolve_device

    cfg = HTDEMUCS_4S
    device = resolve_device(args.device)
    flat = P.init_flat(P.htdemucs_schema(cfg), seed=0)
    model = build_model(cfg, P.from_state_dict(flat, P.htdemucs_schema(cfg)), device)

    n_samples = int(args.track_secs * 44100)
    rng = np.random.default_rng(0)
    tracks = [(rng.standard_normal((2, n_samples)) * 0.1).astype(np.float32)
              for _ in range(args.tracks)]
    total_audio_s = args.tracks * args.track_secs

    opts = ApplyOptions(batch_size=args.batch, shift_offset=1337,
                        transfer_int16=not args.f32_transfer,
                        pipeline_depth=args.pipeline_depth, fused_track=args.fused)
    sep = Separator(model, cfg.num_sources, opts, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sep.separate_many(tracks[:1])  # warm: kernels, cuDNN plans, pinned buffers
    sync()
    t0 = time.perf_counter()
    outs = sep.separate_many(tracks)
    dt = time.perf_counter() - t0
    assert len(outs) == args.tracks
    print(json.dumps({
        "mode": "separate_many", "tracks": args.tracks, "track_secs": args.track_secs,
        "wall_s": dt, "audio_s_per_s": total_audio_s / dt,
        "int16_transfer": not args.f32_transfer,
        "pipeline_depth": args.pipeline_depth, "fused": args.fused,
        "device": str(device)}))

    t0 = time.perf_counter()
    sep(tracks[0])
    dt = time.perf_counter() - t0
    print(json.dumps({"mode": "single_track", "track_secs": args.track_secs,
                      "wall_s": dt, "audio_s_per_s": args.track_secs / dt}))

    stream = StreamingSeparator(model, cfg.num_sources, max_batch=args.batch, device=device)
    chunk = 44100
    for pos in range(0, n_samples, chunk):  # warm
        stream.push(tracks[0][:, pos:pos + chunk])
    stream.flush()
    t0 = time.perf_counter()
    for tr in tracks:
        for pos in range(0, n_samples, chunk):
            stream.push(tr[:, pos:pos + chunk])
        stream.flush()
    dt = time.perf_counter() - t0
    print(json.dumps({"mode": "streaming_1s_pushes", "tracks": args.tracks,
                      "track_secs": args.track_secs, "wall_s": dt,
                      "audio_s_per_s": total_audio_s / dt, "max_batch": args.batch}))

    if not (args.http or args.concurrent > 1):
        return 0
    with tempfile.TemporaryDirectory() as td:
        model_path = f"{td}/model.bin"
        P.write_ggml(model_path, "htdemucs_4s", flat)
        bodies = []
        for i in range(max(args.concurrent, 1)):
            A.write_wav(f"{td}/in{i}.wav", tracks[i % len(tracks)])
            bodies.append(open(f"{td}/in{i}.wav", "rb").read())

        if args.http:
            srv, url = _server(model_path, args, transfer_int16=not args.f32_transfer)
            try:
                _post(url, bodies[0])  # warm
                t0 = time.perf_counter()
                blob = _post(url, bodies[0])
                dt = time.perf_counter() - t0
            finally:
                _stop(srv)
            assert len(zipfile.ZipFile(io.BytesIO(blob)).namelist()) == cfg.num_sources
            print(json.dumps({"mode": "http_request", "track_secs": args.track_secs,
                              "wall_s": dt, "audio_s_per_s": args.track_secs / dt}))

        if args.concurrent > 1:
            N = args.concurrent
            # not fused: the concurrent requests' segments share the
            # feeder's batches, the path under test
            srv, url = _server(model_path, args, transfer_int16=not args.f32_transfer,
                               fused=False)
            try:
                _post(url, bodies[0])  # warm
                calls0 = srv.feeder.stats["device_calls"]
                t0 = time.perf_counter()
                for body in bodies:
                    _post(url, body)
                dt_serial = time.perf_counter() - t0
                calls_serial = srv.feeder.stats["device_calls"] - calls0
                threads = [threading.Thread(target=_post, args=(url, body)) for body in bodies]
                calls0 = srv.feeder.stats["device_calls"]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                dt_conc = time.perf_counter() - t0
                calls = srv.feeder.stats["device_calls"] - calls0
            finally:
                _stop(srv)
            print(json.dumps({
                "mode": "http_concurrent", "concurrent": N, "track_secs": args.track_secs,
                "serial_wall_s": dt_serial, "concurrent_wall_s": dt_conc,
                "speedup": dt_serial / dt_conc, "device_calls_concurrent": calls,
                "device_calls_serial": calls_serial,
                "audio_s_per_s": N * args.track_secs / dt_conc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

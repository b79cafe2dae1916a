"""A minimal HTTP separation server on `serving.DemixSession`: the port of
`demucs_tpu/tools/serve.py`, with the same endpoints, bodies and status
codes. Stdlib only (http.server, zipfile).

Weights stay resident on the device and each request is one track. One
`service.DeviceFeeder` thread owns the device: concurrent /separate and
/stream requests submit segments that it assembles into shared
`batch_size` device calls, so N concurrent uploads cost about one
batched run, and a slow /stream client never blocks other requests (its
handler thread holds no device resource between chunks). Fused
whole-track passes run as exclusive FIFO items on the same queue.

Endpoints:
    GET  /health    -> {"status": "ok", "sources": [...], "feeder": stats}
    POST /separate  -> body: WAV bytes (44.1 kHz) -> application/zip of
                       target_{i}_{stem}.wav (PCM16 under int16
                       transfers, the default). 413 before reading a body
                       over the limit, 400 on one that is not a WAV.
    POST /stream    -> body: raw little-endian float32 interleaved stereo
                       frames (Content-Length or chunked) -> a chunked raw
                       float32 response, each chunk = finalized frames x
                       sources x 2, emitted as audio arrives
                       (`streaming.StreamingSeparator`). A client must read
                       the response while it uploads: one that uploads
                       everything first can deadlock itself once both
                       socket buffers fill (the server guards itself with a
                       socket timeout).

The JAX server also turns on XLA's persistent compile cache; nothing is
compiled here (the CUDA kernels are built once into the package's
`_build/`), so it has no counterpart. `--precompile` warms the fused
buckets of the given track lengths (`Separator.warmup`): on the card it
runs the kernels and cuDNN's plans once, and builds the buckets' plans.

Usage:
    python -m demucs_tpu_torch.tools.serve MODEL.bin [--ft-dir DIR]
        [--port 8642] [--batch 8] [--segment-samples N] [--f32-transfer]
        [--no-fused] [--precompile 30,120] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import sys
import tempfile
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

MAX_BODY_BYTES = 256 * 1024 * 1024  # ~50 min of stereo f32 wav


def make_handler(session, options, feeder, max_body=MAX_BODY_BYTES):
    from .. import audio
    from ..streaming import StreamingSeparator

    class Handler(BaseHTTPRequestHandler):
        # a stalled client (not reading its chunked response, or not
        # sending its body) times out its own handler thread only; the
        # feeder never waits on a socket
        timeout = 600

        def log_message(self, fmt, *a):  # to stderr, not stdout
            print("serve:", fmt % a, file=sys.stderr)

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok",
                                 "sources": list(session.sources),
                                 "feeder": dict(feeder.stats)})
            else:
                self._json(404, {"error": "unknown path"})

        def _iter_body(self, max_total):
            """The request body in blocks: Content-Length (read ~1 s of
            audio at a time) or Transfer-Encoding: chunked (which
            BaseHTTPRequestHandler does not decode)."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            total = 0
            if "chunked" in te:
                while True:
                    line = self.rfile.readline(1024).strip()
                    size = int(line.split(b";")[0] or b"0", 16)
                    if size == 0:
                        self.rfile.readline()  # blank line after the last chunk
                        return
                    total += size
                    if total > max_total:
                        raise ValueError(f"stream exceeds {max_total} bytes")
                    data = self.rfile.read(size)
                    self.rfile.read(2)  # the chunk's CRLF
                    yield data
            else:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_total:
                    raise ValueError(f"stream exceeds {max_total} bytes")
                step = 4 * 2 * 44100  # ~1 s of interleaved stereo f32
                got = 0
                while got < n:
                    data = self.rfile.read(min(step, n - got))
                    if not data:
                        return
                    got += len(data)
                    yield data

        def _do_stream(self):
            """Chunked streaming separation: finalized stems leave as audio
            arrives. The device calls go through the shared feeder (this
            stream's segments batch with other requests'), so a stream
            holds no device resource between its chunks."""
            S = len(session.sources)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Sources", ",".join(session.sources))
            self.send_header("X-Layout", "frames x sources x 2, float32 LE")
            self.end_headers()

            def emit(out):
                if out.size == 0 or out.shape[-1] == 0:
                    return
                # (S, 2, n) -> (n, S, 2), frame-major, so that a client
                # reads sample frames as they land
                b = np.ascontiguousarray(out.transpose(2, 0, 1).astype("<f4")).tobytes()
                self.wfile.write(b"%X\r\n" % len(b) + b + b"\r\n")

            # no device state of its own: every segment runs in the feeder's
            # shared batches, the batched path of /separate
            stream = StreamingSeparator(
                None, S, segment_samples=options.segment_samples,
                run_batch=lambda b: feeder.submit_segments(b).result())
            leftover = b""
            for data in self._iter_body(max_body):
                buf = leftover + data
                nf = len(buf) // 8
                leftover = buf[nf * 8:]
                if nf:
                    frames = np.frombuffer(buf[:nf * 8], "<f4").reshape(nf, 2)
                    emit(stream.push(np.ascontiguousarray(frames.T)))
            emit(stream.flush())
            self.wfile.write(b"0\r\n\r\n")

        def do_POST(self):
            if self.path == "/stream":
                try:
                    self._do_stream()
                except (ValueError, OSError) as e:
                    # the headers may be out already: log and drop
                    print(f"serve: /stream aborted: {e}", file=sys.stderr)
                    self.close_connection = True
                return
            if self.path != "/separate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length header"})
                return
            if n > max_body:
                # refused before reading: the threading server would hold
                # every oversized body in memory
                self._json(413, {"error": f"body {n} bytes exceeds limit {max_body}"})
                return
            try:
                raw = self.rfile.read(n)
                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(raw)
                    f.flush()
                    track = audio.load_track(f.name)
                if options.fused_track:
                    # the whole-track pass: one exclusive FIFO item on the
                    # feeder (streams interleave between tracks)
                    stems = feeder.run_exclusive(
                        lambda: session.demix_track(track, options)).result()
                else:
                    # the batched path: this track's segments share device
                    # batches with every other request in flight
                    stems = feeder.separate(track)
            except (ValueError, OSError) as e:
                self._json(400, {"error": str(e)})
                return

            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as z:
                for i, name in enumerate(session.sources):
                    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                        # int16 transfers -> PCM16 responses (the same
                        # precision, half the bytes)
                        audio.write_wav(f.name, np.asarray(stems[i]),
                                        pcm16=options.transfer_int16)
                        z.writestr(f"target_{i}_{name}.wav", Path(f.name).read_bytes())
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def make_server(model_path=None, port=0, segment_samples=None, batch=8,
                transfer_int16=True, fused=True, precompile_secs=(),
                fused_cache_limit=8, ft_dir=None, device="cuda"):
    """The server of one model file (or, with ft_dir, of the fine-tuned
    bag) on 127.0.0.1:port (0: any free port), not yet serving.

    transfer_int16 (on by default): stems cross the device-to-host link as
    int16 and the response WAVs are PCM16, which halves both transfers
    (`pipeline.PCM16_TRANSFER_SCALE`); False for bit-exact f32. The fused
    path runs with geometric buckets ("geo": exact output for any length,
    log-many plans over all upload lengths) and an LRU cap of
    fused_cache_limit plans; precompile_secs warms the buckets of those
    track lengths at startup. A non-fused server runs one zero batch at
    startup instead. device: "cuda" (default; raises without a GPU) or
    "cpu". All device work runs on the feeder's thread (`srv.feeder`)."""
    from ..pipeline import ApplyOptions
    from ..service import DeviceFeeder
    from ..serving import BagDemixSession, DemixSession

    if (model_path is None) == (ft_dir is None):
        raise ValueError("provide exactly one of model_path or ft_dir")
    # ft_dir: the fine-tuned bag through the same endpoints (the
    # reference's premium configuration, cli-apps/demucs_ft.cpp:136-241)
    session = (BagDemixSession(ft_dir, device=device) if ft_dir
               else DemixSession(model_path, device=device))
    options = ApplyOptions(batch_size=batch, transfer_int16=transfer_int16,
                           fused_track=fused, fused_buckets="geo" if fused else "exact",
                           ).with_segment(segment_samples)
    sep = session._separator(options)
    sep.fused_cache_limit = fused_cache_limit
    # the feeder drives the batched segment step (/stream's, and
    # /separate's when not fused); fused tracks run as exclusive items
    batch_sep = session._separator(
        dataclasses.replace(options, fused_track=False, fused_buckets="exact"))
    feeder = DeviceFeeder(batch_sep)
    if transfer_int16:
        print("serve: responses are PCM16 WAVs (int16 device transfers; pass "
              "--f32-transfer for bit-exact f32)", file=sys.stderr)
    if fused and precompile_secs:
        from ..config import SAMPLE_RATE

        for s in precompile_secs:
            print(f"serve: warming the fused bucket of {s:g} s tracks ...", file=sys.stderr)
            feeder.run_exclusive(lambda s=s: sep.warmup([int(float(s) * SAMPLE_RATE)])).result()
        print(f"serve: {len(sep._fused_cache)} fused plan(s) ready", file=sys.stderr)
    if not fused:
        # every /separate request rides the batched step: run it once
        # before the first request. A fused server skips this: its
        # /separate never uses it, and streams may never come
        print("serve: warming the batched segment step ...", file=sys.stderr)
        zero = np.zeros((batch_sep.options.batch_size, 2, options.segment_samples), np.float32)
        feeder.run_exclusive(lambda: batch_sep._call_device(batch_sep._place(zero))).result()
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(session, options, feeder))
    srv.session, srv.separator, srv.feeder = session, sep, feeder
    return srv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="HTTP separation server")
    ap.add_argument("model", nargs="?", help="ggml weight file (or use --ft-dir)")
    ap.add_argument("--ft-dir", default=None,
                    help="directory with the 4 htdemucs_ft_* files: serve the "
                         "fine-tuned bag (per-stem selection) through the same "
                         "endpoints")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-samples", type=int, default=None)
    ap.add_argument("--f32-transfer", action="store_true",
                    help="bit-exact f32 stem transfers and f32 WAV responses "
                         "(2x the bytes of the int16 default)")
    ap.add_argument("--no-fused", action="store_true",
                    help="the batched path for /separate: concurrent clients' "
                         "segments share device batches, instead of one fused "
                         "pass per track")
    ap.add_argument("--precompile", default="",
                    help="comma-separated track lengths in seconds whose fused "
                         "buckets are warmed at startup (e.g. 30,120,240)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default; fails without one) or the CPU")
    args = ap.parse_args(argv)
    if bool(args.model) == bool(args.ft_dir):
        ap.error("provide exactly one of `model` or --ft-dir")

    srv = make_server(args.model, args.port, args.segment_samples, args.batch,
                      transfer_int16=not args.f32_transfer, fused=not args.no_fused,
                      precompile_secs=[float(s) for s in args.precompile.split(",") if s],
                      ft_dir=args.ft_dir, device=args.device)
    print(f"listening on http://127.0.0.1:{srv.server_address[1]}", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.feeder.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's HTTP server (`demucs_tpu_torch/tools/serve.py`) on the CPU,
full-width htdemucs-4s on 16384-sample segments, port 0: /health, a
/separate round trip against `session.demix_track`, 400 on garbage and
413 on an oversized Content-Length, /stream against a direct
`StreamingSeparator`, a stream that does not hold up /separate,
concurrent uploads sharing the feeder's batches, and a --ft-dir server.
The ports of tests/test_serve.py's cases."""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from demucs_tpu_torch import audio
from demucs_tpu_torch import params as P
from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.pipeline import PCM16_TRANSFER_SCALE, ApplyOptions
from demucs_tpu_torch.streaming import StreamingSeparator
from demucs_tpu_torch.tools.serve import MAX_BODY_BYTES, main, make_server

from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 16384
N = 20000
STEMS = ("drums", "bass", "other", "vocals")


def _model_file(path, seed=0):
    P.write_ggml(path, "htdemucs_4s", P.init_flat(P.htdemucs_schema(HTDEMUCS_4S), seed=seed))
    return path


def _start(**kw):
    srv = make_server(port=0, segment_samples=SEG, device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()
    srv.feeder.close()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = _model_file(tmp_path_factory.mktemp("serve") / "m.bin")
    yield path
    path.unlink()  # full-width files are large; the suite keeps its temp dirs


@pytest.fixture(scope="module")
def server(model_path):
    """The default server (fused, int16 transfers), with the geo bucket of
    N-sample uploads warmed at startup."""
    srv = _start(model_path=str(model_path), batch=2, precompile_secs=[N / 44100.0])
    yield srv
    _stop(srv)


@pytest.fixture(scope="module")
def batched_server(model_path):
    """Not fused: concurrent /separate requests share the feeder's batches."""
    srv = _start(model_path=str(model_path), batch=4, fused=False)
    yield srv
    _stop(srv)


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _track(seed):
    return (np.random.default_rng(seed).standard_normal((2, N)) * 0.2).astype(np.float32)


def _wav_bytes(track, tmp_path, name="in.wav"):
    audio.write_wav(tmp_path / name, track)
    return (tmp_path / name).read_bytes()


def _separate(srv, body):
    req = urllib.request.Request(f"{_url(srv)}/separate", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.headers["Content-Type"] == "application/zip"
        return r.read()


def _stems(blob, tmp_path):
    """The zip's PCM16 WAVs -> (S, 2, n), after checking their names."""
    out = []
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = sorted(z.namelist())
        assert names == [f"target_{i}_{n}.wav" for i, n in enumerate(STEMS)]
        for name in names:
            (tmp_path / name).write_bytes(z.read(name))
            stem, rate = audio.read_wav(tmp_path / name)
            assert rate == 44100
            out.append(stem)
    return np.stack(out)


def _pcm16(x):
    """What a PCM16 response WAV holds for stems x, as read back."""
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0) / 32768.0


def _int16_budget(track):
    """The int16 transfer's budget (tests/test_pipeline.py: two steps at the
    track's std) plus the response WAV's PCM16 error (|x| / 32768 and half
    a step)."""
    std = track.mean(0).std(ddof=1)
    return 2.0 / PCM16_TRANSFER_SCALE * max(std, 1.0) + 1.5 / 32767


def _stream(srv, track, step=4410):
    """POST /stream with a chunked body -> (S, 2, n) stems."""
    host, port = srv.server_address
    con = http.client.HTTPConnection(host, port, timeout=300)
    con.putrequest("POST", "/stream")
    con.putheader("Transfer-Encoding", "chunked")
    con.endheaders()
    frames = np.ascontiguousarray(track.T.astype("<f4"))
    for i in range(0, track.shape[-1], step):
        b = frames[i:i + step].tobytes()
        con.send(b"%X\r\n" % len(b) + b + b"\r\n")
    con.send(b"0\r\n\r\n")
    resp = con.getresponse()
    assert resp.status == 200
    assert resp.headers["X-Sources"] == ",".join(STEMS)
    body = resp.read()
    con.close()
    return np.frombuffer(body, "<f4").reshape(-1, len(STEMS), 2).transpose(1, 2, 0)


def test_health(server):
    with urllib.request.urlopen(f"{_url(server)}/health", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["sources"] == list(STEMS)
    assert set(body["feeder"]) == {"device_calls", "segments", "padded", "exclusive_calls"}


def test_separate_roundtrip_matches_session(server, tmp_path):
    # the startup warmup built exactly one geo bucket, which the request reuses
    warmed = dict(server.separator._fused_cache)
    assert len(warmed) == 1
    track = _track(0)
    got = _stems(_separate(server, _wav_bytes(track, tmp_path)), tmp_path)
    assert dict(server.separator._fused_cache).keys() == warmed.keys()
    opts = ApplyOptions(batch_size=2, transfer_int16=True, fused_track=True,
                        fused_buckets="geo").with_segment(SEG)
    ref = server.session.demix_track(track, opts)
    assert got.shape == ref.shape == (4, 2, N)
    # the same pass on the same inputs: the stems differ by the response's
    # PCM16 encoding alone
    np.testing.assert_allclose(got, _pcm16(ref), rtol=0, atol=1.0 / 32768)


def test_separate_rejects_garbage_and_oversized(server):
    req = urllib.request.Request(f"{_url(server)}/separate", data=b"not a wav at all",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400 and "error" in json.loads(e.value.read())
    # refused from the header alone, before any body is read
    con = http.client.HTTPConnection(*server.server_address, timeout=30)
    con.putrequest("POST", "/separate")
    con.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    con.endheaders()
    resp = con.getresponse()
    assert resp.status == 413 and "exceeds" in json.loads(resp.read())["error"]
    con.close()


def test_stream_matches_direct_streaming(server):
    track = _track(8)
    stream = StreamingSeparator(server.session.model, len(STEMS), segment_samples=SEG,
                                max_batch=2, device="cpu")
    ref = np.concatenate([o for o in (stream.push(track), stream.flush()) if o.shape[-1]], -1)
    got = _stream(server, track)
    assert got.shape == (4, 2, N)
    # the endpoint's segments ride the feeder's int16 transfers; the
    # direct stream's are f32 (denormalized by the stream's std)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_int16_budget(track))


def test_stream_does_not_block_separate(server, tmp_path):
    """A /stream request left open mid-track, after its first segment ran,
    does not hold up a /separate."""
    track = _track(11)
    host, port = server.server_address
    con = http.client.HTTPConnection(host, port, timeout=300)
    con.putrequest("POST", "/stream")
    con.putheader("Transfer-Encoding", "chunked")
    con.endheaders()
    frames = np.ascontiguousarray(track.T.astype("<f4"))
    b = frames[:17000].tobytes()  # more than one segment
    con.send(b"%X\r\n" % len(b) + b + b"\r\n")
    _stems(_separate(server, _wav_bytes(_track(12), tmp_path)), tmp_path)
    b = frames[17000:].tobytes()
    con.send(b"%X\r\n" % len(b) + b + b"\r\n")
    con.send(b"0\r\n\r\n")
    resp = con.getresponse()
    assert resp.status == 200
    got = np.frombuffer(resp.read(), "<f4").reshape(-1, len(STEMS), 2)
    con.close()
    assert got.shape[0] == N and np.isfinite(got).all()


def test_concurrent_separates_share_batches(batched_server, tmp_path):
    """4 concurrent uploads of 2 segments each at batch 4: fewer device
    calls than one padded batch per request, and every request gets its
    own stems."""
    tracks = [_track(20 + i) for i in range(4)]
    bodies = [_wav_bytes(tr, tmp_path, f"t{i}.wav") for i, tr in enumerate(tracks)]
    stats = batched_server.feeder.stats
    calls0, segs0 = stats["device_calls"], stats["segments"]
    results, errs = [None] * 4, []

    def post(i):
        try:
            results[i] = _separate(batched_server, bodies[i])
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    # 8 segments: 2 full batches when shared, 4 calls one request at a
    # time; at most 3 shows a batch shared across requests (the first
    # request may run alone while the others are in flight)
    assert stats["segments"] - segs0 == 8
    assert stats["device_calls"] - calls0 <= 3
    opts = ApplyOptions(batch_size=4, transfer_int16=True).with_segment(SEG)
    for tr, blob in zip(tracks, results):
        ref = batched_server.session.demix_track(tr, opts)
        np.testing.assert_allclose(_stems(blob, tmp_path), np.clip(ref, -1, 1), rtol=0,
                                   atol=_int16_budget(tr))


def test_ft_dir_server_roundtrip(tmp_path):
    """--ft-dir serves the fine-tuned bag through the same endpoints."""
    ftd = tmp_path / "ft"
    ftd.mkdir()
    for i, stem in enumerate(STEMS):
        _model_file(ftd / f"htdemucs_ft_{stem}.bin", seed=i)
    srv = _start(ft_dir=str(ftd), batch=2, fused=False)
    for path in ftd.iterdir():
        path.unlink()  # loaded; full-width files are large
    try:
        with urllib.request.urlopen(f"{_url(srv)}/health", timeout=30) as r:
            assert json.loads(r.read())["sources"] == list(STEMS)
        track = _track(13)
        got = _stems(_separate(srv, _wav_bytes(track, tmp_path)), tmp_path)
        ref = srv.session.demix_track(
            track, ApplyOptions(batch_size=2, transfer_int16=True).with_segment(SEG))
        np.testing.assert_allclose(got, np.clip(ref, -1, 1), rtol=0, atol=_int16_budget(track))
        streamed = _stream(srv, track, step=N)
        assert streamed.shape == (4, 2, N) and np.isfinite(streamed).all()
    finally:
        _stop(srv)


def test_server_defaults_to_cuda(model_path, monkeypatch):
    """Without a GPU the default device raises, from make_server and from
    the command line; exactly one of a model and --ft-dir is taken."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        make_server(str(model_path), port=0)
    with pytest.raises(RuntimeError, match="no GPU"):
        main([str(model_path), "--port", "0"])
    with pytest.raises(ValueError, match="exactly one"):
        make_server(port=0, device="cpu")


def test_bench_serving_defaults_to_cuda(monkeypatch):
    """The load generator runs on the GPU unless asked for the CPU: without
    one it raises before it builds the model."""
    from demucs_tpu_torch.tools import bench_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench_serving.main(["--tracks", "1"])

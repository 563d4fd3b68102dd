"""The port's servers (``serving/``) and gRPC client (``cli/``) on the CPU:
the cases of ``tests/test_serving.py`` re-run against the port (health, the
tenant gates, both HTTP routes, no file, the metrics exposition, gRPC unary,
a stream with partials and EOS, a real RPC cancelled mid-request, the stream
tenant gate), the port's responses held field by field against the JAX
package's servers on the fp32 ``test`` config with the same weights
(``models/params.from_jax_numpy``; only wall-clock fields left out), and the
service's lifecycle (``serve(block=False)``, the CLI's unary and real-time
stream calls, ``/debug/profile`` under ``torch.profiler``, ``shutdown``
leaving no thread behind).

Floats are compared within 1e-4 (the engine tests' bound for probabilities:
fp32 log-probabilities that agree to ~1e-6); everything else is equal.

JAX is imported only inside the fixtures that need it, so that the ``cuda``
case, which serves one gRPC request from a random ``tiny`` model on the card,
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_serving.py
"""

import asyncio
import importlib
import io
import logging
import socket
import threading
import time
from concurrent import futures

import grpc
import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from sentiric_stt_whisper_service_tpu_torch.audio import write_wav
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.runtime import SttEngine
from sentiric_stt_whisper_service_tpu_torch.serving import main as serving_main
from sentiric_stt_whisper_service_tpu_torch.serving.grpc_server import (
    SttServicer,
    add_servicer_to_server,
)
from sentiric_stt_whisper_service_tpu_torch.serving.health import add_health_to_server
from sentiric_stt_whisper_service_tpu_torch.serving.http_server import HttpServer, MetricsServer
from sentiric_stt_whisper_service_tpu_torch.serving.metrics import AppMetrics
from sentiric_stt_whisper_service_tpu_torch.serving.proto import stt_pb2
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

cli = importlib.import_module("sentiric_stt_whisper_service_tpu_torch.cli.main")
SERVICE = "sentiric.stt.v1.SttWhisperService"
# The engine tests' relaxed gates (random weights keep their segments), fp32.
RELAXED = dict(enable_vad=False, parallel_requests=1, beam_size=1, best_of=1,
               quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
               min_segment_avg_prob=0.0, compute_type="float32")
WALL_CLOCK = ("processing_time", "rtf")  # the HTTP reply's meta fields timed on the host


@pytest.fixture(scope="module")
def pair():
    """(port engine, JAX engine) over the same fp32 weights of ``test``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
    from sentiric_stt_whisper_service_tpu.models import whisper as ref_whisper
    from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
    from sentiric_stt_whisper_service_tpu_torch.models import config_for
    from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy

    cfg_r = ref_whisper.config_for("test", dtype=jnp.float32)
    params = ref_whisper.init_params(cfg_r, jax.random.key(0))
    theirs = ref_engine.SttEngine(RefSettings(**RELAXED), model_name="test", params=params)
    theirs.cfg = cfg_r  # the reference engine takes its dtype from its config
    model = from_jax_numpy(jax.tree.map(np.asarray, params),
                           config_for("test", dtype=torch.float32), "cpu")
    mine = SttEngine(Settings(device="cpu", **RELAXED), model_name="test", params=model)
    yield mine, theirs
    mine.shutdown()
    theirs.shutdown()


@pytest.fixture(scope="module")
def engine(pair):
    return pair[0]


def make_wav(seconds: float = 1.0, seed: int = 5) -> bytes:
    """tests/test_serving.py's clip: a modulated 180 Hz tone with noise."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    audio = (0.15 * np.sin(2 * np.pi * 180 * t) * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t))
             + 0.003 * rng.standard_normal(n))
    buf = io.BytesIO()
    write_wav(buf, audio.astype(np.float32), 16000)
    return buf.getvalue()


@pytest.fixture(scope="module")
def wav_bytes():
    return make_wav()


def assert_same(got, want, path="$"):
    """Equal structure and values; floats within 1e-4."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-4, abs=1e-4), path
    else:
        assert got == want, path


def as_dict(msg) -> dict:
    return MessageToDict(msg, preserving_proto_field_name=True,
                         always_print_fields_with_no_presence=True)


async def _client(app):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def http_call(app, route, fields=(), headers=None):
    """POST a multipart form to ``route`` of ``app``: (status, JSON)."""
    async def run():
        import aiohttp

        client = await _client(app)
        try:
            form = aiohttp.FormData()
            for name, value in fields:
                if isinstance(value, bytes):
                    form.add_field(name, value, filename="a.wav")
                else:
                    form.add_field(name, value)
            resp = await client.post(route, data=form, headers=headers or {})
            return resp.status, await resp.json()
        finally:
            await client.close()

    return asyncio.run(run())


def http_get(app, route):
    async def run():
        client = await _client(app)
        try:
            resp = await client.get(route)
            return resp.status, await resp.text(), dict(resp.headers)
        finally:
            await client.close()

    return asyncio.run(run())


def start_grpc(servicer_cls, add_fn, engine, health=None):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    add_fn(servicer_cls(engine, AppMetrics()), server)
    if health is not None:
        health(server, engine.is_ready)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


@pytest.fixture(scope="module")
def grpc_addr(engine):
    server, addr = start_grpc(SttServicer, add_servicer_to_server, engine, add_health_to_server)
    yield addr
    server.stop(grace=None)


def unary(addr, request, metadata=(("x-tenant-id", "t1"),), timeout=120):
    with grpc.insecure_channel(addr) as ch:
        call = ch.unary_unary(
            f"/{SERVICE}/WhisperTranscribe",
            request_serializer=stt_pb2.WhisperTranscribeRequest.SerializeToString,
            response_deserializer=stt_pb2.WhisperTranscribeResponse.FromString,
        )
        return call(request, metadata=metadata, timeout=timeout)


def stream(addr, wav: bytes, metadata=(("x-tenant-id", "t1"),), timeout=300):
    with grpc.insecure_channel(addr) as ch:
        call = ch.stream_stream(
            f"/{SERVICE}/WhisperTranscribeStream",
            request_serializer=stt_pb2.WhisperTranscribeStreamRequest.SerializeToString,
            response_deserializer=stt_pb2.WhisperTranscribeStreamResponse.FromString,
        )

        def reqs():
            body = wav[44:]
            for i in range(0, len(body), 16000):  # 0.5 s chunks
                yield stt_pb2.WhisperTranscribeStreamRequest(audio_chunk=body[i : i + 16000])
            yield stt_pb2.WhisperTranscribeStreamRequest(audio_chunk=b"")

        return list(call(reqs(), metadata=metadata, timeout=timeout))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- HTTP


def test_health(engine):
    status, body, _ = http_get(HttpServer(engine, AppMetrics(), engine.settings).app, "/health")
    import json

    data = json.loads(body)
    assert status == 200
    assert data["status"] == "healthy" and data["model_ready"] is True
    assert data["service"] == "sentiric-stt-whisper-service"
    assert data["api_compatibility"] == "openai-whisper"


def test_transcribe_requires_tenant(engine, wav_bytes):
    app = HttpServer(engine, AppMetrics(), engine.settings).app
    status, data = http_call(app, "/v1/transcribe", [("file", wav_bytes)])
    assert status == 400 and "tenant_id" in data["error"]


@pytest.mark.parametrize("route", ["/v1/transcribe", "/v1/audio/transcriptions"])
def test_transcribe_json_shape(engine, wav_bytes, route):
    app = HttpServer(engine, AppMetrics(), engine.settings).app
    status, data = http_call(app, route, [("file", wav_bytes), ("language", "en"),
                                          ("diarization", "true")], {"X-Tenant-ID": "t1"})
    assert status == 200
    assert set(data) == {"text", "language", "duration", "segments", "meta"}
    assert set(data["meta"]) == {"processing_time", "rtf", "input_sr", "input_channels",
                                 "tokens"}
    assert data["meta"]["input_sr"] == 16000
    assert data["duration"] == pytest.approx(1.0, abs=0.01)
    assert data["segments"]  # the relaxed gates keep the random model's segments
    for seg in data["segments"]:
        assert set(seg) == {
            "text", "start", "end", "probability", "speaker_turn_next", "speaker_id",
            "gender", "emotion", "arousal", "valence", "pitch_mean", "pitch_std",
            "energy_mean", "energy_std", "spectral_centroid", "zero_crossing_rate",
            "speaker_vec", "words"}
        assert len(seg["speaker_vec"]) == 8


def test_no_file_400(engine):
    app = HttpServer(engine, AppMetrics(), engine.settings).app
    status, _ = http_call(app, "/v1/transcribe", [("language", "en")], {"X-Tenant-ID": "t"})
    assert status == 400


def test_metrics_exposition(engine, wav_bytes):
    http = HttpServer(engine, AppMetrics(), engine.settings)
    http_call(http.app, "/v1/transcribe", [("file", wav_bytes)], {"X-Tenant-ID": "t"})
    status, body, headers = http_get(MetricsServer(http.metrics).app, "/metrics")
    assert status == 200 and headers["Access-Control-Allow-Origin"] == "*"
    for series in ("stt_requests_total", "stt_request_latency_seconds",
                   "stt_audio_seconds_processed_total", "stt_tokens_generated_total"):
        assert series in body
    assert "stt_requests_total 1.0" in body
    assert "stt_audio_seconds_processed_total 1.0" in body


@pytest.mark.parametrize("route", ["/v1/transcribe", "/v1/audio/transcriptions"])
def test_http_matches_reference(pair, wav_bytes, route):
    from sentiric_stt_whisper_service_tpu.serving import http_server as ref_http
    from sentiric_stt_whisper_service_tpu.serving.metrics import AppMetrics as RefMetrics

    mine, theirs = pair
    fields = [("file", wav_bytes), ("language", "en"), ("diarization", "true")]
    headers = {"X-Tenant-ID": "t1"}
    got = http_call(HttpServer(mine, AppMetrics(), mine.settings).app, route, fields, headers)
    want = http_call(ref_http.HttpServer(theirs, RefMetrics(), theirs.settings).app, route,
                     fields, headers)
    assert got[0] == want[0] == 200
    for reply in (got[1], want[1]):
        for key in WALL_CLOCK:
            reply["meta"].pop(key)
    assert got[1]["segments"]
    assert_same(got[1], want[1])


# ---------------------------------------------------------------- gRPC


def test_grpc_unary_requires_tenant(grpc_addr, wav_bytes):
    with pytest.raises(grpc.RpcError) as err:
        unary(grpc_addr, stt_pb2.WhisperTranscribeRequest(audio_data=wav_bytes), metadata=())
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_unary(grpc_addr, wav_bytes):
    resp = unary(grpc_addr, stt_pb2.WhisperTranscribeRequest(audio_data=wav_bytes,
                                                             language="en"))
    assert isinstance(resp.transcription, str) and resp.transcription
    assert len(resp.speaker_vec) in (0, 8)
    assert resp.duration == pytest.approx(1.0, abs=0.01)


def test_grpc_health_serving(grpc_addr):
    with grpc.insecure_channel(grpc_addr) as ch:
        check = ch.unary_unary("/grpc.health.v1.Health/Check")
        assert check(b"", timeout=30) == bytes([0x08, 1])  # status: SERVING


def test_grpc_stream_partials_and_eos(grpc_addr, wav_bytes):
    responses = stream(grpc_addr, wav_bytes)
    assert responses and responses[-1].is_final
    first_final = next(i for i, r in enumerate(responses) if r.is_final)
    assert all(not r.is_final for r in responses[:first_final])
    assert all(r.is_final for r in responses[first_final:])
    assert all(r.transcription.endswith(" ") for r in responses[:first_final])


def test_grpc_unary_cancel_aborts_decode(grpc_addr, engine, wav_bytes, monkeypatch):
    """A cancelled RPC reaches the engine's abort machinery: the servicer
    wires ``should_abort`` to ``context.is_active``. The spy holds the
    request until the cancellation arrives, then lets the engine run: its
    pre-check returns nothing at once. (Mid-decode stops are covered by the
    sampling and beam tests, and on the card by chip_smoke.py phase 9.)"""
    seen, started = {}, threading.Event()
    orig = engine.transcribe_pcm16

    def spy(pcm, sr, options, *a, **kw):
        assert options.should_abort is not None, "servicer left should_abort unset"
        started.set()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not options.should_abort():
            time.sleep(0.02)
        seen["abort_fired"] = options.should_abort()
        t0 = time.monotonic()
        seen["results"] = orig(pcm, sr, options, *a, **kw)
        seen["decode_s"] = time.monotonic() - t0
        return seen["results"]

    monkeypatch.setattr(engine, "transcribe_pcm16", spy)
    with grpc.insecure_channel(grpc_addr) as ch:
        call = ch.unary_unary(
            f"/{SERVICE}/WhisperTranscribe",
            request_serializer=stt_pb2.WhisperTranscribeRequest.SerializeToString,
            response_deserializer=stt_pb2.WhisperTranscribeResponse.FromString,
        )
        fut = call.future(stt_pb2.WhisperTranscribeRequest(audio_data=wav_bytes, language="en"),
                          metadata=(("x-tenant-id", "t1"),))
        assert started.wait(60), "request never reached the engine"
        fut.cancel()
        with pytest.raises((grpc.RpcError, grpc.FutureCancelledError)):
            fut.result(timeout=60)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and "results" not in seen:
        time.sleep(0.05)
    assert seen.get("abort_fired") is True, "cancellation never reached should_abort"
    assert seen.get("results") == [], "aborted decode still produced results"
    assert seen.get("decode_s", 99) < 5.0, "aborted decode did not return early"


def test_grpc_stream_requires_tenant(grpc_addr):
    with grpc.insecure_channel(grpc_addr) as ch:
        call = ch.stream_stream(
            f"/{SERVICE}/WhisperTranscribeStream",
            request_serializer=stt_pb2.WhisperTranscribeStreamRequest.SerializeToString,
            response_deserializer=stt_pb2.WhisperTranscribeStreamResponse.FromString,
        )
        with pytest.raises(grpc.RpcError) as err:
            list(call(iter([stt_pb2.WhisperTranscribeStreamRequest(audio_chunk=b"ab")]),
                      timeout=30))
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


@pytest.fixture(scope="module")
def grpc_pair(pair):
    from sentiric_stt_whisper_service_tpu.serving import grpc_server as ref_grpc

    mine, theirs = pair
    servers = [start_grpc(SttServicer, add_servicer_to_server, mine),
               start_grpc(ref_grpc.SttServicer, ref_grpc.add_servicer_to_server, theirs)]
    yield servers[0][1], servers[1][1]
    for server, _ in servers:
        server.stop(grace=None)


def test_grpc_unary_matches_reference(grpc_pair, wav_bytes):
    request = stt_pb2.WhisperTranscribeRequest(audio_data=wav_bytes)  # language auto
    got, want = (unary(addr, request) for addr in grpc_pair)
    assert got.transcription and got.words
    assert_same(as_dict(got), as_dict(want))


def test_grpc_stream_matches_reference(grpc_pair):
    wav = make_wav(2.0, seed=3)
    got, want = (stream(addr, wav) for addr in grpc_pair)
    assert any(not r.is_final for r in got) and got[-1].is_final
    assert_same([as_dict(r) for r in got], [as_dict(r) for r in want])


# ---------------------------------------------------------------- lifecycle


def _non_daemon_threads():
    return {t for t in threading.enumerate() if not t.daemon and t is not threading.main_thread()}


def _serve(device, model, monkeypatch):
    """The service at random weights without warm-up, on free local ports;
    the root logger's handlers and level come back after the test
    (``serve`` installs the JSON log format)."""
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", list(root.handlers))
    monkeypatch.setattr(root, "level", root.level)
    monkeypatch.setenv("STT_WHISPER_SERVICE_WARMUP", "false")
    settings = Settings(device=device, model_filename=f"ggml-{model}.bin", host="127.0.0.1",
                        grpc_port=free_port(), http_port=free_port(), metrics_port=free_port(),
                        **{k: v for k, v in RELAXED.items() if k != "compute_type"})
    return settings, serving_main.serve(settings, random_init=True, block=False)


def test_serve_cli_and_shutdown(monkeypatch, capsys, wav_bytes):
    """``serve(block=False)`` on the CPU, the CLI's unary call and its
    real-time stream (0.5 s chunks every 0.5 s), a one-second
    ``/debug/profile`` trace, then ``shutdown``: no thread left behind."""
    import json
    import urllib.request

    before = _non_daemon_threads()
    settings, (engine, server, apps, stop) = _serve("cpu", "test", monkeypatch)
    try:
        assert engine.device.type == "cpu" and not stop.is_set()
        with grpc.insecure_channel(f"127.0.0.1:{settings.grpc_port}") as ch:
            resp = cli._unary(ch, wav_bytes)
            sent, received = cli._stream(ch, wav_bytes)
        assert resp.duration == pytest.approx(1.0, abs=0.01)
        assert len(sent) == 3 and sent[1] - sent[0] >= cli.CHUNK_S  # 2 chunks at real time, EOS
        assert received and received[-1][1].is_final and received[-1][0] > sent[-1]
        assert "Transcription :" in capsys.readouterr().out
        base = f"http://127.0.0.1:{settings.http_port}"
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read())["model_ready"] is True
        req = urllib.request.Request(base + "/debug/profile?seconds=0.2", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
        assert reply["seconds"] == 0.2
        with open(f"{reply['trace_dir']}/trace.json") as f:
            assert "traceEvents" in json.load(f)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{settings.metrics_port}/metrics", timeout=30) as r:
            assert b"stt_requests_total 2.0" in r.read()  # the unary call and the stream
    finally:
        serving_main.shutdown(engine, server, apps, grace=1.0)
    assert not any(app.thread.is_alive() for app in apps)
    assert _non_daemon_threads() <= before


def test_profile_on_the_card_takes_no_device_lock(pair, monkeypatch):
    """``/debug/profile`` on the card records through the port's CUPTI
    recorder (``serving/device_trace.record``, stubbed here) and holds no
    lock that device work waits on: while the recorder runs, another thread
    takes the engine's ``DeviceLock`` exclusively (a graph capture) and
    shared (device work). The reply's fields are the JAX package's
    ``/debug/profile`` reply's, as are its seconds."""
    import json
    import types
    from pathlib import Path

    from sentiric_stt_whisper_service_tpu.serving.http_server import HttpServer as RefHttpServer
    from sentiric_stt_whisper_service_tpu.serving.metrics import AppMetrics as RefAppMetrics
    from sentiric_stt_whisper_service_tpu_torch.models.graphs import DeviceLock
    from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

    card = types.SimpleNamespace(device=torch.device("cuda"), _device=DeviceLock(),
                                 is_ready=lambda: True)
    taken = []

    def recording(seconds, path):
        def device_work():
            with card._device.exclusive():
                taken.append("exclusive")
            with card._device.shared():
                taken.append("shared")

        other = threading.Thread(target=device_work)
        other.start()
        other.join(timeout=30)
        assert not other.is_alive(), "device work waited on the profile"
        Path(path).write_text(json.dumps({"traceEvents": []}))
        return device_trace.TraceStats(events=0)

    monkeypatch.setattr(device_trace, "record", recording)
    status, reply = http_call(HttpServer(card, AppMetrics(), Settings(device="cpu")).app,
                              "/debug/profile?seconds=0.1")
    assert status == 200 and taken == ["exclusive", "shared"]
    with open(f"{reply['trace_dir']}/trace.json") as f:
        assert json.load(f)["traceEvents"] == []
    _, theirs = pair
    ref_status, ref_reply = http_call(RefHttpServer(theirs, RefAppMetrics(), theirs.settings).app,
                                      "/debug/profile?seconds=0.1")
    assert ref_status == status and set(ref_reply) == set(reply)
    assert ref_reply["seconds"] == reply["seconds"] == 0.1


def test_device_trace_gates_graph_launches_only_at_start_and_stop(monkeypatch, tmp_path):
    """``device_trace.record`` (the recorder's C calls stubbed) holds
    ``models.graphs.GRAPH_LAUNCHES`` exclusively around CUPTI's start and
    stop and around each group of markers between them (the gate held
    by the recording thread), where a graph launch in another thread
    waits, and nowhere else:
    a launch goes through while the trace records and while it writes. It
    calls the start and the stop through the loaded library's attributes
    (where the benchmark wraps them), with the port's tracer on at both and
    off once it returns."""
    from sentiric_stt_whisper_service_tpu_torch import tracing
    from sentiric_stt_whisper_service_tpu_torch.models.graphs import GRAPH_LAUNCHES
    from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

    def launch_waits() -> bool:
        """Whether a graph launch in another thread waits on the gate."""
        entered = threading.Event()

        def launch():
            with GRAPH_LAUNCHES.shared():
                entered.set()

        threading.Thread(target=launch, daemon=True).start()
        return not entered.wait(0.2)

    seen = {}
    marks = []  # whether each group of markers held graph launches back

    class Recorder:
        def sstw_trace_start(self):
            seen["start"] = launch_waits()
            seen["on at start"] = tracing.on
            return 0

        def sstw_trace_stop(self):
            seen["stop"] = launch_waits()
            seen["on at stop"] = tracing.on
            return 0

        def sstw_trace_write(self, path):
            seen["write"] = launch_waits()
            with open(path, "w") as f:
                f.write('{"traceEvents": []}')
            return 0

        def sstw_trace_counts(self, out):
            for i in range(4):
                out[i] = 0

        def sstw_trace_device(self, ordinal):
            pass

        def sstw_trace_mark(self):
            marks.append(GRAPH_LAUNCHES._writer == threading.get_ident())
            return 0

        def sstw_trace_marks(self, out, cap):
            return 0

        def sstw_trace_copy(self, starts, ends, cap):
            return 0

    loaded = Recorder()
    start, stop = loaded.sstw_trace_start, loaded.sstw_trace_stop
    called = []
    loaded.sstw_trace_start = lambda: called.append("start") or start()
    loaded.sstw_trace_stop = lambda: called.append("stop") or stop()
    monkeypatch.setattr(device_trace, "lib", lambda: loaded)
    monkeypatch.setattr(device_trace, "LEAD_IN_S", 0.0)  # the recorder starts at once
    stats = []
    tracer = threading.Thread(
        target=lambda: stats.append(device_trace.record(1.0, str(tmp_path / "trace.json"))))
    tracer.start()
    time.sleep(0.5)  # inside the trace's second
    seen["recording"] = launch_waits()
    tracer.join(timeout=30)
    assert not tracer.is_alive() and stats[0].events == 0
    assert seen == {"start": True, "recording": False, "stop": True, "write": False,
                    "on at start": True, "on at stop": True}
    assert called == ["start", "stop"] and not tracing.on
    assert marks and all(marks)


@pytest.mark.cuda
def test_serve_one_grpc_request_on_the_card(monkeypatch):
    """``serve`` on the card (a random ``tiny``: head dim 64, which the
    kernels take; bf16, int4 compute) answers one unary gRPC request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sentiric_stt_whisper_service_tpu_torch import kernels

    settings, (engine, server, apps, _) = _serve("cuda", "tiny", monkeypatch)
    try:
        assert engine.device.type == "cuda"
        kernels.reset_launch_counts()
        with grpc.insecure_channel(f"127.0.0.1:{settings.grpc_port}") as ch:
            resp = cli._unary(ch, make_wav(3.0))
        assert resp.duration == pytest.approx(3.0, abs=0.01) and resp.transcription
        assert kernels.LAUNCHES["log_mel"] and kernels.LAUNCHES["flash_attention"]
    finally:
        serving_main.shutdown(engine, server, apps, grace=1.0)

"""HTTP API, Studio host and metrics server (aiohttp) over the port's
``SttEngine``: the JAX package's ``serving/http_server.py`` with the same
routes and JSON.

  * ``GET /health`` → {status, model_ready, service, version,
    api_compatibility} with 200/503;
  * ``POST /v1/transcribe`` ≡ ``POST /v1/audio/transcriptions``
    (OpenAI-compatible): multipart fields file/language/prompt/temperature/
    beam_size/audio_ctx/translate/diarization/prosody_lpf_alpha/
    prosody_pitch_gate; the tenant-id header gate; text/language/duration/
    segments[...affective block...]/meta{rtf,...};
  * ``POST /debug/profile?seconds=N``: a trace of the next N seconds (on
    the card every kernel it runs, through the port's CUPTI recorder,
    ``serving/device_trace.py``; on the CPU ``torch.profiler``'s CPU
    activities), written as a Chrome trace into a new temporary directory
    whose path the reply gives;
  * the Studio static files (``studio/`` at the repository root) at ``/``;
  * ``GET /metrics`` on its own port with CORS.

Blocking engine work runs on the event loop's executor threads, so requests
overlap; the engine's admission semaphore is the concurrency gate.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path
from typing import Optional

from aiohttp import web

from ..audio import parse_wav_robust
from ..config import Settings
from ..prosody.extractor import ProsodyOptions
from ..runtime import EngineBusyException, RequestOptions, SttEngine
from . import device_trace
from .metrics import AppMetrics
from .suts_logging import APP_VERSION, suts_error, suts_info

CORS = {"Access-Control-Allow-Origin": "*"}


def _json(data, status=200):
    return web.json_response(data, status=status, headers=CORS)


def segments_json(results) -> list[dict]:
    """The ``segments`` of a transcription reply, one per result."""
    return [
        {
            "text": r.text,
            "start": r.t0 / 100.0,
            "end": r.t1 / 100.0,
            "probability": r.prob,
            "speaker_turn_next": r.speaker_turn_next,
            "speaker_id": r.speaker_id,
            "gender": r.affective.gender_proxy,
            "emotion": r.affective.emotion_proxy,
            "arousal": r.affective.arousal,
            "valence": r.affective.valence,
            "pitch_mean": r.affective.pitch_mean,
            "pitch_std": r.affective.pitch_std,
            "energy_mean": r.affective.energy_mean,
            "energy_std": r.affective.energy_std,
            "spectral_centroid": r.affective.spectral_centroid,
            "zero_crossing_rate": r.affective.zero_crossing_rate,
            "speaker_vec": [float(x) for x in r.affective.speaker_vec],
            "words": [
                {"word": t.text, "start": t.t0 / 100.0, "end": t.t1 / 100.0,
                 "probability": t.p}
                for t in r.tokens
            ],
        }
        for r in results
    ]


class HttpServer:
    def __init__(
        self,
        engine: SttEngine,
        metrics: AppMetrics,
        settings: Settings,
        studio_dir: Optional[str] = None,
    ):
        self.engine = engine
        self.metrics = metrics
        self.settings = settings
        self.app = web.Application(client_max_size=512 * 1024 * 1024)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_post("/v1/transcribe", self.transcribe)
        self.app.router.add_post("/v1/audio/transcriptions", self.transcribe)
        self.app.router.add_post("/debug/profile", self.profile)
        studio = Path(studio_dir or Path(__file__).resolve().parents[2] / "studio")
        if studio.is_dir():
            self.app.router.add_get("/", self._index(studio))
            self.app.router.add_static("/", str(studio), show_index=False)

    @staticmethod
    def _index(studio: Path):
        async def handler(request):
            return web.FileResponse(studio / "index.html")

        return handler

    async def health(self, request: web.Request):
        ready = self.engine.is_ready()
        return _json(
            {
                "status": "healthy" if ready else "unhealthy",
                "model_ready": ready,
                "service": "sentiric-stt-whisper-service",
                "version": APP_VERSION,
                "api_compatibility": "openai-whisper",
            },
            status=200 if ready else 503,
        )

    async def profile(self, request: web.Request):
        """Trace the next ``seconds`` (at most 30): on the card every kernel
        it runs, from every thread (CUPTI); on the CPU the CPU activities.
        Replies with the directory of the Chrome trace."""
        import tempfile

        try:
            seconds = min(30.0, float(request.query.get("seconds", "2")))
        except ValueError:
            return _json({"error": "bad seconds"}, 400)
        out_dir = tempfile.mkdtemp(prefix="sstw_trace_")
        await asyncio.get_running_loop().run_in_executor(
            None, self._trace, seconds, str(Path(out_dir) / "trace.json"))
        return _json({"trace_dir": out_dir, "seconds": seconds})

    def _trace(self, seconds: float, path: str) -> None:
        """One executor thread records the next ``seconds`` and writes the
        trace; the device and the request threads run on meanwhile, as
        beside the JAX package's ``jax.profiler`` trace. On the card the
        port's recorder (``device_trace.record``) takes the card's kernels,
        eager and graph nodes, and writes the JSON after its stop, outside
        the interpreter lock and without the engine's device lock (that
        lock, held around ``torch.profiler``'s stop, held the card for tens
        of seconds); its start and stop hold back graph launches only
        while they run. On the CPU ``torch.profiler`` takes the CPU
        activities. The stop's wait and hold, the write's seconds and the
        join of the port's host spans with the kernel records
        (``device_trace.describe``) are logged (PROFILE_WRITTEN)."""
        if self.engine.device.type == "cuda":
            st = device_trace.record(seconds, path)
            suts_info(
                "PROFILE_WRITTEN", "", "", "",
                "Trace of %.1f s written to %s: %d kernel events (%d records dropped), %d host "
                "spans; the stop waited %.3f s for the graph launches in flight and held the "
                "device's graph launches %.3f s; written in %.3f s; %s",
                seconds, path, st.events, st.dropped, st.spans, st.wait_s, st.stop_s,
                st.write_s, device_trace.describe(st),
            )
            return
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            time.sleep(seconds)
        finally:
            t0 = time.perf_counter()
            prof.stop()
        t1 = time.perf_counter()
        prof.export_chrome_trace(path)
        suts_info(
            "PROFILE_WRITTEN", "", "", "",
            "Trace of %.1f s written to %s: the stop waited 0.000 s and held the device 0.000 "
            "s (no lock taken): it took %.3f s; written in %.3f s",
            seconds, path, t1 - t0, time.perf_counter() - t1,
        )

    async def transcribe(self, request: web.Request):
        self.metrics.requests_total.inc()
        trace_id = request.headers.get("x-trace-id", "unknown")
        span_id = request.headers.get("x-span-id", "unknown")
        tenant_id = request.headers.get("x-tenant-id", "unknown")

        if tenant_id == "unknown":
            suts_error(
                "MISSING_TENANT_ID", trace_id, span_id, tenant_id,
                "Tenant ID is missing in HTTP headers. Request rejected.",
            )
            return _json({"error": "tenant_id header is strictly required"}, 400)
        if not self.engine.is_ready():
            return _json({"error": "Model not ready"}, 503)

        fields: dict[str, bytes] = {}
        try:
            reader = await request.multipart()
            async for part in reader:
                if part.name:
                    fields[part.name] = await part.read(decode=False)
        except (AssertionError, ValueError):
            return _json({"error": "No file uploaded."}, 400)
        if "file" not in fields:
            return _json({"error": "No file uploaded."}, 400)

        opts = RequestOptions()
        if "language" in fields:
            opts.language = fields["language"].decode(errors="replace")
        if "prompt" in fields:
            opts.prompt = fields["prompt"].decode(errors="replace")
        for name, cast, attr in (
            ("temperature", float, "temperature"),
            ("beam_size", int, "beam_size"),
            ("audio_ctx", int, "audio_ctx"),
        ):
            if name in fields:
                try:
                    setattr(opts, attr, cast(fields[name].decode()))
                except ValueError:
                    pass
        for name, attr in (("translate", "translate"), ("diarization", "enable_diarization")):
            if name in fields:
                val = fields[name].decode(errors="replace")
                setattr(opts, attr, val in ("true", "1"))
        p_opts = ProsodyOptions()
        try:
            if "prosody_lpf_alpha" in fields:
                p_opts = ProsodyOptions(
                    lpf_alpha=float(fields["prosody_lpf_alpha"].decode()),
                    gender_threshold=p_opts.gender_threshold,
                )
        except ValueError:
            pass
        try:
            if "prosody_pitch_gate" in fields:
                p_opts = ProsodyOptions(
                    lpf_alpha=p_opts.lpf_alpha,
                    gender_threshold=float(fields["prosody_pitch_gate"].decode()),
                )
        except ValueError:
            pass
        opts.prosody_opts = p_opts
        # Abort the decode when the HTTP client disconnects: aiohttp
        # cancels the handler task, but the transcription runs in an
        # executor thread that would otherwise finish the full decode.
        opts.should_abort = (
            lambda: request.transport is None or request.transport.is_closing()
        )

        suts_info(
            "HTTP_TRANSCRIBE_REQUEST", trace_id, span_id, tenant_id,
            "Processing: %db | Lang: %s | LPF: %.3f",
            len(fields["file"]), opts.language, opts.prosody_opts.lpf_alpha,
        )

        try:
            start = time.perf_counter()
            audio = await asyncio.get_running_loop().run_in_executor(
                None, parse_wav_robust, bytes(fields["file"])
            )
            if audio.pcm_data.size == 0:
                raise ValueError("Parsed WAV data is empty.")
            results = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: self.engine.transcribe_pcm16(
                    audio.pcm_data, audio.sample_rate, opts
                ),
            )
            processing_time = time.perf_counter() - start

            segments = segments_json(results)
            full_text = "".join(r.text for r in results)
            detected_lang = results[-1].language if results else "unknown"
            total_tokens = sum(r.token_count for r in results)
            duration = audio.pcm_data.size / float(audio.sample_rate)
            self.metrics.audio_seconds_processed_total.inc(duration)
            self.metrics.request_latency.observe(processing_time)
            self.metrics.tokens_generated_total.inc(total_tokens)
            return _json(
                {
                    "text": full_text,
                    "language": detected_lang,
                    "duration": duration,
                    "segments": segments,
                    "meta": {
                        "processing_time": processing_time,
                        "rtf": processing_time / (duration if duration > 0 else 1.0),
                        "input_sr": audio.sample_rate,
                        "input_channels": audio.channels,
                        "tokens": total_tokens,
                    },
                }
            )
        except EngineBusyException as e:
            suts_error("ENGINE_BUSY", trace_id, span_id, tenant_id, str(e))
            return _json({"error": str(e)}, 503)
        except Exception as e:  # noqa: BLE001 — the reference replies 500 with the message
            suts_error(
                "TRANSCRIPTION_ERROR", trace_id, span_id, tenant_id,
                "Transcription error: %s", e,
            )
            return _json({"error": str(e)}, 500)


class MetricsServer:
    """Prometheus exposition on its own port with CORS."""

    def __init__(self, metrics: AppMetrics):
        self.metrics = metrics
        self.app = web.Application()
        self.app.router.add_get("/metrics", self.expose)
        self.app.router.add_options("/metrics", self.options)

    async def expose(self, request):
        return web.Response(
            body=self.metrics.expose(),
            content_type="text/plain",
            charset="utf-8",
            headers={
                **CORS,
                "Access-Control-Allow-Methods": "GET, OPTIONS",
                "Access-Control-Allow-Headers": "Content-Type",
            },
        )

    async def options(self, request):
        return web.Response(
            status=204,
            headers={
                **CORS,
                "Access-Control-Allow-Methods": "GET, OPTIONS",
                "Access-Control-Allow-Headers": "Content-Type",
            },
        )

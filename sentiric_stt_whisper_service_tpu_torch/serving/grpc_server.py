"""gRPC service ``sentiric.stt.v1.SttWhisperService`` over the port's
``SttEngine``: the JAX package's ``serving/grpc_server.py`` with the same
wire surface.

  * unary ``WhisperTranscribe``: x-trace-id/x-span-id/x-tenant-id metadata,
    INVALID_ARGUMENT without a tenant, robust audio parse, the first
    result's text, language, affective block and words; ``should_abort``
    follows ``context.is_active()``, so a cancelled call stops its decode on
    the device at the next abort chunk;
  * bidi ``WhisperTranscribeStream``: a thin shell over
    ``runtime/streaming.StreamingSession`` (an empty chunk is EOS and
    finalizes the buffer; a partial every ``stream_buffer_samples`` new
    samples; finals at the 30 s cap). The stream occupies one worker thread
    for its whole life and its ticks run there. A tick that raises is
    logged (``STT_STREAM_ERROR``) and the stream goes on, as in the
    reference.

``proto/stt_pb2.py`` is a byte-for-byte copy of the JAX package's (one
serialized descriptor, so both load in one process); the servicer
registration below is the hand-written equivalent of grpc_tools'
``_pb2_grpc`` boilerplate.
"""

from __future__ import annotations

from concurrent import futures

import grpc

from ..audio import parse_wav_robust
from ..config import Settings
from ..runtime import RequestOptions, StreamingSession, SttEngine
from .metrics import AppMetrics
from .proto import stt_pb2
from .suts_logging import suts_debug, suts_error, suts_info

_SERVICE = "sentiric.stt.v1.SttWhisperService"


def _fill_affective(msg, result):
    aff = result.affective
    msg.gender_proxy = aff.gender_proxy
    msg.emotion_proxy = aff.emotion_proxy
    msg.arousal = aff.arousal
    msg.valence = aff.valence
    msg.pitch_mean = aff.pitch_mean
    msg.pitch_std = aff.pitch_std
    msg.energy_mean = aff.energy_mean
    msg.energy_std = aff.energy_std
    msg.spectral_centroid = aff.spectral_centroid
    msg.zero_crossing_rate = aff.zero_crossing_rate
    del msg.speaker_vec[:]
    msg.speaker_vec.extend(float(v) for v in aff.speaker_vec)
    msg.speaker_id = result.speaker_id


def _fill_words(msg, result):
    for token in result.tokens:
        w = msg.words.add()
        w.word = token.text
        w.start = token.t0 / 100.0
        w.end = token.t1 / 100.0
        w.probability = token.p


def _metadata_ids(context) -> tuple[str, str, str]:
    md = dict(context.invocation_metadata())
    return (
        md.get("x-trace-id", "unknown"),
        md.get("x-span-id", "unknown"),
        md.get("x-tenant-id", "unknown"),
    )


class SttServicer:
    def __init__(self, engine: SttEngine, metrics: AppMetrics):
        self.engine = engine
        self.metrics = metrics

    # ------------------------------------------------------------------
    def WhisperTranscribe(self, request, context):
        trace_id, span_id, tenant_id = _metadata_ids(context)
        if tenant_id in ("", "unknown"):
            suts_error(
                "MISSING_TENANT_ID", trace_id, span_id, tenant_id,
                "Tenant ID is missing in gRPC metadata. Request rejected.",
            )
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "tenant_id is strictly required for isolation",
            )
        self.metrics.requests_total.inc()
        suts_info(
            "STT_UNARY_REQUEST", trace_id, span_id, tenant_id,
            "Unary gRPC Transcribe requested.",
        )
        if not self.engine.is_ready():
            context.abort(grpc.StatusCode.UNAVAILABLE, "Model not ready")
        try:
            audio = parse_wav_robust(request.audio_data)
        except Exception:
            suts_error(
                "STT_INVALID_AUDIO", trace_id, span_id, tenant_id,
                "Invalid audio format received.",
            )
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "Invalid audio")

        options = RequestOptions()
        if request.HasField("language"):
            options.language = request.language
        # Client cancellation reaches the decode loop: a disconnected
        # caller stops a window mid-decode instead of burning the full
        # budget (the reference service plumbs an abort callback but its
        # servers never set it).
        options.should_abort = lambda: not context.is_active()

        results = self.engine.transcribe_pcm16(
            audio.pcm_data, audio.sample_rate, options
        )
        response = stt_pb2.WhisperTranscribeResponse()
        # duration is audio-derived: filled even when every segment was
        # gated out (as the HTTP handler does).
        response.duration = audio.pcm_data.size / float(audio.sample_rate)
        if results:
            r = results[0]
            response.transcription = r.text
            response.language = r.language
            _fill_affective(response, r)
            _fill_words(response, r)
            # language_probability is the detect-language max softmax
            # prob (engine._resolve_language), not a token-prob proxy.
            response.language_probability = r.language_probability
        else:
            # Fully-gated clip: language "unknown", as the HTTP handler
            # reports it, so the two protocols agree on the same input.
            response.language = "unknown"
        suts_info(
            "STT_UNARY_COMPLETE", trace_id, span_id, tenant_id,
            "Unary transcription completed.",
        )
        return response

    # ------------------------------------------------------------------
    def WhisperTranscribeStream(self, request_iterator, context):
        trace_id, span_id, tenant_id = _metadata_ids(context)
        if tenant_id in ("", "unknown"):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "tenant_id is strictly required for isolation",
            )
        self.metrics.requests_total.inc()
        suts_info(
            "STT_STREAM_STARTED", trace_id, span_id, tenant_id,
            "New gRPC Stream Connection started.",
        )
        if not self.engine.is_ready():
            context.abort(grpc.StatusCode.UNAVAILABLE, "Model not ready")

        settings: Settings = self.engine.get_settings()
        session = StreamingSession(
            self.engine,
            # A cancelled stream aborts the in-flight tick decode too,
            # not just the between-reads loop check below.
            RequestOptions(should_abort=lambda: not context.is_active()),
            incremental=settings.stream_incremental,
        )

        for request in request_iterator:
            if not context.is_active():
                return
            chunk = request.audio_chunk
            if len(chunk) == 0 and session.buffer.size:
                suts_debug(
                    "STT_EOS_RECEIVED", trace_id, span_id, tenant_id,
                    "EOS signal received. Finalizing %d samples.",
                    session.buffer.size,
                )
            try:
                events = session.feed(chunk)
            except Exception as e:  # noqa: BLE001 — stream must survive
                suts_error(
                    "STT_STREAM_ERROR", trace_id, span_id, tenant_id,
                    "Streaming error: %s", e,
                )
                continue
            for ev in events:
                resp = stt_pb2.WhisperTranscribeStreamResponse()
                resp.transcription = ev.result.text
                resp.is_final = ev.is_final
                _fill_affective(resp, ev.result)
                if ev.is_final:
                    _fill_words(resp, ev.result)
                    suts_info(
                        "STT_TRANSCRIPT_FINALIZED", trace_id, span_id,
                        tenant_id, "Final Sentence: '%s' [Spk: %s]",
                        ev.result.text, ev.result.speaker_id,
                    )
                yield resp
        suts_info(
            "STT_STREAM_COMPLETED", trace_id, span_id, tenant_id,
            "gRPC Stream Connection closed cleanly.",
        )


def add_servicer_to_server(servicer: SttServicer, server: grpc.Server):
    """Hand-written _pb2_grpc equivalent."""
    handlers = {
        "WhisperTranscribe": grpc.unary_unary_rpc_method_handler(
            servicer.WhisperTranscribe,
            request_deserializer=stt_pb2.WhisperTranscribeRequest.FromString,
            response_serializer=stt_pb2.WhisperTranscribeResponse.SerializeToString,
        ),
        "WhisperTranscribeStream": grpc.stream_stream_rpc_method_handler(
            servicer.WhisperTranscribeStream,
            request_deserializer=stt_pb2.WhisperTranscribeStreamRequest.FromString,
            response_serializer=stt_pb2.WhisperTranscribeStreamResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
    )


def build_server(
    engine: SttEngine,
    metrics: AppMetrics,
    settings: Settings,
    max_workers: int = 8,
) -> grpc.Server:
    """Build the gRPC server with an insecure or mTLS listener (the
    reference service's main.cpp:131-146). gRPC never shuts down the worker
    pool it is given, so the pool rides along as ``server.worker_pool`` for
    ``serving.main.shutdown``."""
    pool = futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="grpc-worker")
    server = grpc.server(pool)
    server.worker_pool = pool
    add_servicer_to_server(SttServicer(engine, metrics), server)
    from .health import add_health_to_server

    add_health_to_server(server, engine.is_ready)
    addr = f"{settings.host}:{settings.grpc_port}"
    if settings.grpc_cert_path and settings.grpc_key_path:
        with open(settings.grpc_key_path, "rb") as f:
            key = f.read()
        with open(settings.grpc_cert_path, "rb") as f:
            cert = f.read()
        root = None
        require_client = False
        if settings.grpc_ca_path:
            with open(settings.grpc_ca_path, "rb") as f:
                root = f.read()
            require_client = True
        creds = grpc.ssl_server_credentials(
            [(key, cert)],
            root_certificates=root,
            require_client_auth=require_client,
        )
        server.add_secure_port(addr, creds)
    else:
        server.add_insecure_port(addr)
    return server

"""Prometheus metrics: a copy of the JAX package's ``serving/metrics.py``,
the reference service's four series (its main.cpp:96-118) with the same
names and buckets."""

from __future__ import annotations

from prometheus_client import CollectorRegistry, Counter, Histogram, generate_latest


class AppMetrics:
    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.requests_total = Counter(
            "stt_requests_total",
            "Total transcription requests",
            registry=self.registry,
        )
        self.request_latency = Histogram(
            "stt_request_latency_seconds",
            "Transcription latency",
            buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 30.0),
            registry=self.registry,
        )
        self.audio_seconds_processed_total = Counter(
            "stt_audio_seconds_processed_total",
            "Total seconds of audio processed",
            registry=self.registry,
        )
        self.tokens_generated_total = Counter(
            "stt_tokens_generated_total",
            "Total tokens generated",
            registry=self.registry,
        )

    def expose(self) -> bytes:
        return generate_latest(self.registry)

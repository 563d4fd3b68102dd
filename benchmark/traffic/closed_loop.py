"""Closed-loop clients: each sends a request through
``SttEngine.transcribe_pcm16`` (the entry the HTTP and gRPC servers and
the CLI reach), waits for its answer and sends the next, cycling through
the clip pool in one shared order. A client sends no request once the
window has closed; the one it has in flight runs to its end.

Mix keys: ``clients``, ``language``, ``tokens_per_30s``,
``condition_on_previous_text`` (default true) and, optionally,
``beam_size`` (default: the engine's setting).
"""

from __future__ import annotations

import itertools
import threading
import time


def options_for(mix: dict, clip):
    from sentiric_stt_whisper_service_tpu_torch.runtime.engine import RequestOptions

    from .clips import token_budget

    return RequestOptions(
        language=mix["language"],
        max_decode_tokens=token_budget(mix, clip.seconds),
        condition_on_previous_text=mix.get("condition_on_previous_text", True),
        beam_size=mix.get("beam_size", -1),
    )


def drive(run, until: float, max_requests: int = 0, grace_s: float = 90.0) -> list:
    """Send requests from ``run.mix["clients"]`` threads until the clock
    passes ``until`` (or ``max_requests`` were sent); returns the records
    once every client has stopped, or ``grace_s`` after ``until`` (a
    record still without ``done`` never came back)."""
    from sentiric_stt_whisper_service_tpu_torch.runtime.engine import PerformanceMetrics

    order = itertools.cycle(run.pool)
    lock = threading.Lock()
    records = []

    def next_clip():
        with lock:
            if time.perf_counter() >= until or (max_requests and len(records) >= max_requests):
                return None
            rec = run.new_record(next(order))
            records.append(rec)
            return rec

    def client():
        while (rec := next_clip()) is not None:
            run.tap.bind(rec)
            metrics = PerformanceMetrics()
            rec.sent = time.perf_counter()
            try:
                rec.results = run.engine.transcribe_pcm16(
                    rec.clip.pcm, rec.clip.rate, options_for(run.mix, rec.clip), metrics)
            except Exception as e:  # noqa: BLE001 — a refused or failed request counts as failed
                rec.error = f"{type(e).__name__}: {e}"
            rec.done = time.perf_counter()
            rec.metrics = metrics
            run.tap.bind(None)

    threads = [threading.Thread(target=client, name=f"client-{i}", daemon=True)
               for i in range(run.mix["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, until + grace_s - time.perf_counter()))
    return records

"""Milliseconds each request thread spent waiting for the engine's
``_eager`` lock (the request threads' eager encode, detection and
alignment, one at a time) over the traced slice: the port's ``eager`` wait
spans, cut to the device trace's recording, summed and divided by the
request threads with a span in it (``serving/device_trace.last()
.summary()``; the tracer starts a lead-in before the recording, so a wait
under way at its start is seen whole)."""

from benchmark.harness import reader


def read(view):
    s = reader("idle_pct.workers").summary(view)
    return None if s is None else s["counters"]["eager_wait_ms"]

"""Mean live slots per step of the continuous batcher over the traced
slice: Σ(live slots × steps) / Σ steps over the batcher's chunks that
ended while the device trace recorded (the port's counter
``batcher.chunk``, ``serving/device_trace.last().summary()``)."""

from benchmark.harness import reader


def read(view):
    s = reader("idle_pct.workers").summary(view)
    return None if s is None else s["counters"]["live_slots"]

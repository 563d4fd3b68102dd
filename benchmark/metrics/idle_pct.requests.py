"""The share of the traced slice in which no kernel ran on the card, put
down to the engine's request threads (resampling, the VAD gate, the eager
encode, detection and alignment, segments, prosody): as
``idle_pct.workers``, for the role ``request``."""

from benchmark.harness import reader


def read(view):
    return reader("idle_pct.workers").idle_share(view, "request")

"""The share of the traced slice in which no kernel ran on the card, put
down to the continuous batcher's and the beam gang's worker threads: each
idle instant is split evenly among the threads whose innermost open span
is a ``work`` span (the port's own spans, joined with the kernel records
on the recorder's clock: ``serving/device_trace.last().summary()``). It is
that part of ``idle_pct``: the join's idle seconds of the role over its
idle seconds (exact nanoseconds), times ``idle_pct`` (read from the trace
file, whose times the parse rounds), so that the roles' shares never sum
above ``idle_pct``. None without the port's spans, or where the port does
not trust the clock that joins them to the kernels (its marker kernels and
its check of the stages' synchronises: ``summary()["clock"]``)."""

from benchmark.harness import reader


def summary(view):
    """The port's join of the traced slice, or None (no trace, no spans, or
    a port without them)."""
    if view.trace is None or view.trace.window_s <= 0:
        return None
    from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

    last = getattr(device_trace, "last", None)
    stats = last() if last is not None else None
    s = stats.summary() if stats is not None else None
    return s if s and s.get("spans") else None


def idle_share(view, role: str):
    s = summary(view)
    idle = None if s is None else s.get("idle")
    if idle is None:  # no session, or a clock the port does not trust
        return None
    if idle["idle_s"] <= 0:
        return 0.0
    return reader("idle_pct").read(view) * idle["by_role"].get(role, 0.0) / idle["idle_s"]


def read(view):
    return idle_share(view, "worker")

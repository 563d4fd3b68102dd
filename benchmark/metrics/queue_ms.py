"""Mean ``PerformanceMetrics.queue_time_ms`` of the requests completed in
the window: the wait for one of the engine's ``parallel_requests`` slots."""


def read(view):
    qs = [r.metrics.queue_time_ms for r in view.done if r.metrics is not None]
    return sum(qs) / len(qs) if qs else None

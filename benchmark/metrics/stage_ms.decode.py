"""Mean ``PerformanceMetrics.stages_ms["decode"]`` of the requests completed in
the window that ran the stage (the engine's own span, its wait for the
other requests' eager stages included)."""


def read(view):
    ms = [r.metrics.stages_ms["decode"] for r in view.done
          if r.metrics is not None and "decode" in r.metrics.stages_ms]
    return sum(ms) / len(ms) if ms else None

"""The 90th percentile of the wall of every request sent in the window
that came back, from the client's send (queue wait included) to its
answer: those still under way at the window's close count too, once back
(the harness waits for them; one that never comes back fails the run)."""

from benchmark.harness import percentile


def read(view):
    walls = [(r.done - r.sent) * 1e3 for r in view.records
             if r.sent is not None and r.done is not None and r.error is None]
    return percentile(walls, 90) if walls else None

"""K3's share of its roofline in the traced slice: the least time the card
could take for the calls counted while it recorded (each at the sizes its
wrapper gave the kernel library; a graph replay counts its capture's calls;
``bounds.least_seconds``), over K3's device time in the trace."""

from benchmark import bounds, devtrace


def read(view):
    if view.trace is None:
        return None
    least = bounds.least_seconds(view.trace.calls, "K3")
    spent = devtrace.kernel_seconds(view.trace, bounds.TRACE_NAMES["K3"])
    return 100.0 * least / spent if least > 0 and spent > 0 else None

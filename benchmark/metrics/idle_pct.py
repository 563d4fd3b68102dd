"""The share of the traced slice in which no kernel ran on the card."""


def read(view):
    if view.trace is None or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)

"""Audio seconds served in the window, over the window's seconds: what an
operator pays the card for. Each request that came back counts its audio
in the share of its wall (send to answer) that fell inside the window, so
that the requests under way at the window's edges count for the part of
their work done in it."""


def read(view):
    start, end = view.window_start, view.window_start + view.seconds
    total = 0.0
    for r in view.records:
        if r.done is None or r.error is not None or r.done <= r.sent:
            continue
        inside = max(0.0, min(r.done, end) - max(r.sent, start))
        total += r.clip.pcm.size / r.clip.rate * inside / (r.done - r.sent)
    return total / view.seconds

"""The whole step's share of the card's bf16 peak: the model FLOPs of the
work completed in the window (each decoded window encoded at its full
positions, its cross K/V, and its prompt and served tokens through every
decoder layer and the tied logits, once a beam), over the window's
seconds at 989 TFLOP/s."""

from benchmark import bounds


def read(view):
    flops = sum(bounds.window_flops(view.config, len(w["prompt"]) + len(w["tokens"]), w["beam"])
                for r in view.done for w in r.windows)
    return 100.0 * flops / (view.seconds * bounds.BF16_PEAK) if flops else None

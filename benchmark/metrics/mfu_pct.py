"""The whole step's share of the card's bf16 peak: the model FLOPs of the
work completed in the window, as the configuration's model family counts
them (``served_flops`` of each request back inside it), over the window's
seconds at 989 TFLOP/s."""

from benchmark import bounds, families


def read(view):
    family = families.load(view.config)
    flops = sum(family.served_flops(view.config, r) for r in view.done)
    return 100.0 * flops / (view.seconds * bounds.BF16_PEAK) if flops else None

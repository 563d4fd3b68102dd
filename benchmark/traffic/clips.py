"""The pool of audio clips a mix cycles through, made from the seed.

Every seed gets the same set of lengths and the same share of each input
rate: the lengths are the quantiles ``(i + 0.5) / n`` of the mix's
lognormal, clipped to its range, and the first ``round(n * share)`` clips
of the seed's order take the lower rate. The seed decides only the order
and the audio itself (``voiced.voiced_like``), so two seeds give the same
work in another order.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from statistics import NormalDist

import numpy as np

from ..voiced import pcm16, voiced_like


@dataclasses.dataclass
class Clip:
    index: int
    seconds: float
    rate: int
    pcm: np.ndarray  # int16 at ``rate``


def lengths(spec: dict, n: int) -> list:
    """``n`` clip lengths in seconds: quantiles of the lognormal of median
    ``median_s`` and log-sigma ``sigma``, clipped to [``min_s``, ``max_s``]."""
    nd = NormalDist()
    mu = math.log(spec["median_s"])
    out = [math.exp(mu + spec["sigma"] * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return [round(min(max(x, spec["min_s"]), spec["max_s"]), 2) for x in out]


def rates(spec: dict, n: int) -> list:
    """Input rates of ``n`` clips: ``rates`` is {"8000": share, "16000": share}."""
    shares = sorted(((int(r), s) for r, s in spec["rates"].items()), key=lambda x: x[0])
    out = []
    for rate, share in shares[:-1]:
        out += [rate] * round(n * share)
    return out + [shares[-1][0]] * (n - len(out))


def make_pool(spec: dict, seed: int) -> list:
    """The mix's ``pool`` clips for ``seed``, made in threads (each clip's
    audio from a random stream of its own, so the pool is the same
    whatever the threads' order)."""
    n = spec["pool"]
    seed = seed % (2 ** 63)
    rng = np.random.default_rng([seed, 17])
    secs = [lengths(spec, n)[i] for i in rng.permutation(n)]
    rs = [rates(spec, n)[i] for i in rng.permutation(n)]

    def clip(i: int) -> Clip:
        audio = voiced_like(np.random.default_rng([seed, 17, i]), secs[i], rs[i])
        return Clip(i, secs[i], rs[i], pcm16(audio))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(clip, range(n)))


def token_budget(spec: dict, seconds: float) -> int:
    """A window's sampled-token budget: ``tokens_per_30s`` scaled to the
    seconds of audio in it (at most 30)."""
    return max(1, math.ceil(spec["tokens_per_30s"] * min(seconds, 30.0) / 30.0))

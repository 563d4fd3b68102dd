"""The clip pool and the token budget: the same work from every seed, in
another order."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import clips

from .conftest import ROOT

MIXES = ["v3-turns-greedy", "turbo-recordings", "v3-turns-beam5"]


def mix_of(cell: str) -> dict:
    return harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json")["mix"]


@pytest.mark.parametrize("cell", MIXES)
def test_pool_is_deterministic_and_in_range(cell):
    mix = dict(mix_of(cell), pool=6)
    a, b = clips.make_pool(mix, 2**31 + 11), clips.make_pool(mix, 2**31 + 11)
    assert [c.seconds for c in a] == [c.seconds for c in b]
    assert all(np.array_equal(x.pcm, y.pcm) for x, y in zip(a, b))
    for c in a:
        assert mix["min_s"] <= c.seconds <= mix["max_s"]
        assert c.pcm.dtype == np.int16 and c.pcm.size == int(c.seconds * c.rate)
        assert str(c.rate) in mix["rates"]


@pytest.mark.parametrize("cell", MIXES)
def test_every_seed_gets_the_same_sizes_and_rates(cell):
    mix = dict(mix_of(cell), pool=8)
    pools = [clips.make_pool(mix, s) for s in (1, 7, 2**33 + 5)]
    sizes = [sorted(c.seconds for c in p) for p in pools]
    assert sizes[0] == sizes[1] == sizes[2]
    shares = [sorted(c.rate for c in p) for p in pools]
    assert shares[0] == shares[1] == shares[2]
    orders = [[c.seconds for c in p] for p in pools]
    assert orders[0] != orders[1] or orders[1] != orders[2]


def test_turns_are_half_at_8khz_and_lognormal():
    mix = mix_of("v3-turns-greedy")
    pool = clips.make_pool(dict(mix, pool=24), 5)
    assert sum(c.rate == 8000 for c in pool) == 12
    secs = sorted(clips.lengths(mix, 24))
    assert secs[0] >= 2.0 and secs[-1] <= 30.0
    assert abs(np.median(secs) - mix["median_s"]) < 0.5


def test_recordings_are_all_8khz():
    pool = clips.make_pool(dict(mix_of("turbo-recordings"), pool=4), 3)
    assert {c.rate for c in pool} == {8000}


@pytest.mark.parametrize("seconds,budget", [(2.0, 9), (8.0, 35), (30.0, 128), (180.0, 128)])
def test_token_budget(seconds, budget):
    assert clips.token_budget({"tokens_per_30s": 128}, seconds) == budget


def test_voiced_like_is_a_frozen_copy():
    """The copy draws and computes as chip_smoke.voiced_like does."""
    import ast

    src = (ROOT / "chip_smoke.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "voiced_like")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), ns)  # noqa: S102
    from benchmark.voiced import voiced_like

    for sr in (8000, 16000):
        a = ns["voiced_like"](np.random.default_rng(3), 2.5, sr)
        b = voiced_like(np.random.default_rng(3), 2.5, sr)
        assert np.array_equal(a, b)

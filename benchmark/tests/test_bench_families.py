"""Model families: a configuration names its family, and the harness runs
one it has never seen through the five functions alone."""

from __future__ import annotations

import hashlib
import sys
import time

import pytest

from benchmark import families, harness

from .conftest import ROOT, small_config, small_workload

SPEC = harness.load_json(ROOT / "BENCHMARK.json")

# A family that counts each call and hands it on to the Whisper family.
COUNTED = '''
from collections import Counter

from benchmark.families import whisper

CALLS = Counter()


def _counted(name):
    def call(*args, **kwargs):
        CALLS[name] += 1
        return getattr(whisper, name)(*args, **kwargs)
    return call


build, tap, describe, judge, served_flops = (
    _counted(n) for n in ("build", "tap", "describe", "judge", "served_flops"))
'''


def _digest(folder) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("family", [None, "", "../whisper", "no_such_family"])
def test_a_config_without_a_known_family_is_refused(family):
    cfg = small_config()
    cfg.pop("family")
    if family is not None:
        cfg["family"] = family
    with pytest.raises(ValueError):
        families.load(cfg)


def test_a_family_without_the_five_functions_is_refused(tmp_path, monkeypatch):
    (tmp_path / "partial").mkdir()
    (tmp_path / "partial" / "__init__.py").write_text("def build(*a):\n    pass\n")
    monkeypatch.setattr(families, "SEARCH", tmp_path)
    try:
        with pytest.raises(TypeError, match="tap"):
            families.load({"name": "x", "family": "partial"})
    finally:
        sys.modules.pop("benchmark.families.partial", None)


def test_a_new_family_runs_through_run_cell(tmp_path, monkeypatch):
    """A family written outside the benchmark's folder, which hands each call
    on to the Whisper family's, runs a cell at the test size on the CPU
    through ``run_cell``: every one of its five functions is called, the
    result line has its usual keys and compared names, and no file under
    ``benchmark/`` changed."""
    before = _digest(ROOT / "benchmark")
    (tmp_path / "counted").mkdir()
    (tmp_path / "counted" / "__init__.py").write_text(COUNTED)
    monkeypatch.setattr(families, "SEARCH", tmp_path)
    cell = "v3-turns-greedy"
    config = dict(small_config(), family="counted")
    workload = small_workload(cell)
    mfu = next(m for m in SPEC["per_layer"] if m["name"] == "mfu_pct")
    try:
        res = harness.run_cell(config, workload, harness.cell_metrics(SPEC, cell, False) + [mfu],
                               2**31 + 7, 6.0, False, "cpu", time.perf_counter(),
                               log=lambda m: None)
        calls = dict(sys.modules["benchmark.families.counted"].CALLS)
    finally:
        sys.modules.pop("benchmark.families.counted", None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared",
                         "readings"]
    assert set(res["compared"]) == set(workload["check"]["limits"]) | {
        "windows", "never_came_back", "failed_in_error"}
    assert res["correct"] is True and res["compared"]["windows"]["value"] >= 1
    assert {"setup_s", "audio_s_per_s", "mfu_pct"} <= set(res["metrics"])
    assert calls["build"] == calls["tap"] == calls["judge"] == 1
    assert calls["describe"] == 2 and calls["served_flops"] >= 1
    assert _digest(ROOT / "benchmark") == before


class _Seed(Exception):
    pass


@pytest.mark.parametrize("fixed", [None, 2718281828])
def test_the_checkpoint_comes_from_the_cells_weights_seed(monkeypatch, fixed):
    """Set-up and the judge draw the same checkpoint: the workload's
    ``weights_seed`` where it names one, else the run's seed."""
    from benchmark.families import whisper
    from benchmark.families.whisper import system

    def caught(dims, seed, device):
        raise _Seed(seed)

    wl = small_workload("v3-turns-greedy")
    wl.pop("weights_seed", None)
    if fixed is not None:
        wl["weights_seed"] = fixed
    want = 11 if fixed is None else fixed
    monkeypatch.setattr(system, "make_flat", caught)
    with pytest.raises(_Seed) as built:
        whisper.build(small_config(), wl, 11, "cpu")
    with pytest.raises(_Seed) as judged:
        whisper.judge([], small_config(), wl, 11, "cpu")
    assert built.value.args == judged.value.args == (want,)

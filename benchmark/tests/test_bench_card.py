"""On the card (``python -m pytest -m cuda benchmark/tests``; skipped
without one): the control of each cell at the cell's own size, one seed
and a short window of the cell's own traffic. The control (the reference
computed with int4 weights in the program's place) has to read above the
cell's limit on one of its numbers, and the program below every limit; in
the beam cell the reference's beam search with the best candidate of every
beam dropped (``families/whisper/reference.BEAM_FAULTS``) has to read
above the limit of ``beam_not_first``. ``benchmark/families/whisper/control.py``
takes the same readings over many seeds."""

from __future__ import annotations

import time

import pytest

from benchmark import harness

from .conftest import ROOT

SPEC = harness.load_json(ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes_at_full_size(card, cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = harness.load_json(ROOT / next(c["file"] for c in SPEC["configs"]
                                           if c["name"] == entry["config"]))
    workload = harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json")
    res = harness.run_cell(config, workload, [], 2**31 + 3, 15.0, False, "cuda",
                           time.perf_counter(), log=lambda m: None, control=True)
    r, limits = res["readings"], workload["check"]["limits"]
    assert res["correct"] is True
    assert all(r[name] <= lim for name, lim in limits.items())
    assert any(r[f"control_{name}"] > lim for name, lim in limits.items())
    assert all(r[f"fault_prune_{name}"] > lim for name, lim in limits.items()
               if f"fault_prune_{name}" in r)

"""Shared pieces of the benchmark's own tests (``python -m pytest
benchmark/tests``): a test-size configuration of the benchmark's cells, and
the card fixture of the tests that need one."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# Widths cut for a run on the CPU; everything else as in large-v3.
TEST_DIMS = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=1,
                 decoder_attention_heads=1, encoder_ffn_dim=256, decoder_ffn_dim=256,
                 num_hidden_layers=2)


def small_config(name: str = "large-v3") -> dict:
    cfg = harness.load_json(ROOT / "benchmark" / "configs" / f"{name}.json")
    cfg.update(TEST_DIMS)
    return cfg


def small_workload(cell: str) -> dict:
    wl = copy.deepcopy(harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json"))
    mix = wl["mix"]
    if "clients" in mix:
        mix["clients"] = min(mix["clients"], 3)
    mix["pool"] = 4
    if mix["max_s"] > 30:
        mix.update(median_s=40.0, min_s=31.0, max_s=50.0)
    wl["warm_requests"] = 1
    wl["check"]["windows"] = 3
    return wl


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


_RUNS: dict = {}


def cpu_run(cell: str = "v3-turns-greedy", seed: int = 2**31 + 7, control: bool = True) -> dict:
    """One run of ``cell`` on the CPU at the test size (a 6 s window), with
    the control's readings; made once per process."""
    import time

    key = (cell, seed, control)
    if key not in _RUNS:
        spec = harness.load_json(ROOT / "BENCHMARK.json")
        name = cell if cell in {w["name"] for w in spec["workloads"]} else "v3-turns-greedy"
        config = small_config(next(w["config"] for w in spec["workloads"] if w["name"] == name))
        _RUNS[key] = harness.run_cell(config, small_workload(cell),
                                      harness.cell_metrics(spec, name, False), seed, 6.0,
                                      False, "cpu", time.perf_counter(), log=lambda m: None,
                                      control=control)
    return _RUNS[key]

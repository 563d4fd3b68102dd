"""The form of BENCHMARK.json and of a run's result line, the files a
name finds, and the whole-name check of the modules a run may load."""

from __future__ import annotations

import ast
import json
import re
import sys

import pytest

from benchmark import harness

from .conftest import ROOT, cpu_run

SPEC = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def test_every_entry_has_exactly_its_keys_and_one_line_texts():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w["name"]
        assert _line(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert {"name", "unit", "better", "bound", "source"} <= set(m) <= {
            "name", "unit", "better", "bound", "source", "workloads"}, m["name"]
    for m in SPEC["per_layer"]:
        assert {"name", "unit", "better", "source", "layer", "moves"} <= set(m) <= {
            "name", "unit", "better", "source", "layer", "moves", "workloads"}, m["name"]
        assert _line(m["layer"])
    assert all(_line(word) for word in SPEC["command"])
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_name_finds_its_file():
    for c in SPEC["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in SPEC["workloads"]:
        wl = harness.load_json(ROOT / "benchmark" / "workloads" / f"{w['name']}.json")
        assert wl["cell"] == w["name"] and wl["traffic"] == w["traffic"]
        assert (ROOT / "benchmark" / "traffic" / f"{wl['driver']}.py").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.cell_metrics(SPEC, cell, True)
    assert layers and all(m["moves"] in e2e for m in layers)


def test_whole_name_import_check(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax", "sentiric_stt_whisper_service_tpu",
                 "sentiric_stt_whisper_service_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    monkeypatch.setitem(sys.modules, "sentiric_stt_whisper_service_tpu_torch.kernels", object())
    found = harness.banned_modules()
    assert "jaxtyping" not in found
    assert not any(n.startswith("sentiric_stt_whisper_service_tpu_torch") for n in found)
    assert {"jax", "jax.numpy", "jaxlib.xla_client", "flax",
            "sentiric_stt_whisper_service_tpu"} <= set(found)


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for name in ("families/whisper/reference.py", "families/whisper/compare.py",
                 "families/whisper/flops.py", "bounds.py", "voiced.py"):
        assert _imports(ROOT / "benchmark" / name) <= {"__future__", "contextlib", "math",
                                                       "numpy", "torch", "scipy"}, name


def test_nothing_in_the_benchmark_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "sentiric_stt_whisper_service_tpu"}


def test_the_result_line():
    res = cpu_run()
    line = json.dumps({k: v for k, v in res.items() if k != "readings"})
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "compared"
    assert isinstance(back["correct"], bool) and back["attempted"] >= back["failed"] >= 0
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    # request_p90_ms needs a request back inside the test's short window
    assert {"setup_s", "audio_s_per_s"} <= set(back["metrics"]) <= {
        m["name"] for m in harness.cell_metrics(SPEC, "v3-turns-greedy", False)}
    for name, m in back["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(back["device"])
    for c in back["compared"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_every_config_names_a_family_with_the_five_functions(entry):
    from benchmark import families

    cfg = harness.load_json(ROOT / entry["file"])
    assert (ROOT / "benchmark" / "families" / cfg["family"] / "__init__.py").is_file()
    family = families.load(cfg)
    assert all(callable(getattr(family, f)) for f in families.FUNCTIONS)


def _generic_files() -> list:
    bench = ROOT / "benchmark"
    return [bench / "harness.py", bench / "run.py", *sorted((bench / "metrics").glob("*.py"))]


@pytest.mark.parametrize("path", _generic_files(), ids=lambda p: p.name)
def test_the_generic_harness_knows_no_family(path):
    """The harness, the entry and the readers reach a family only through
    ``families.load``: they import nothing under ``families/`` and name
    none of the Whisper family's pieces."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        assert not any(re.search(r"(^|\.)families\.", n) for n in names), (path.name, names)
    text = path.read_text()
    for word in ("hf_shapes", "DecodeTap", "Judge", "window_flops", "_beam_gang",
                 "params_from_hf_state", "make_state", "assign_starts"):
        assert word not in text, (path.name, word)

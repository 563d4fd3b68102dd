"""One run of one cell: set-up, the measured window, the readers, the
comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric or kind
of model is a file found by name: ``configs/<config>.json`` (named in
BENCHMARK.json), ``workloads/<cell>.json`` (the mix, the driver it names
under ``traffic/``, the cell's settings and the limits of its comparison),
``metrics/<metric>.py`` (a ``read(view)`` returning the number, or None
where there is nothing to read) and ``families/<family>/`` (the model
family the configuration names: its weights, engine, tap, judge and FLOPs;
``families/__init__.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names that may not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "sentiric_stt_whisper_service_tpu")
GRACE_S = 60.0  # how long past the window's close a request may take to come back


@dataclasses.dataclass
class Record:
    """One request and what came back."""

    clip: object
    sent: float = None
    done: float = None
    error: str = None
    results: list = None
    metrics: object = None
    windows: list = dataclasses.field(default_factory=list)  # what the family's tap put here


@dataclasses.dataclass
class Run:
    """What a driver needs: the engine, the tap, the mix and the pool."""

    engine: object
    tap: object
    mix: dict
    pool: list
    seed: int

    def new_record(self, clip) -> Record:
        return Record(clip)


@dataclasses.dataclass
class View:
    """What a metric's reader reads."""

    config: dict
    workload: dict
    seconds: float
    setup_s: float
    records: list  # every record sent in the window
    done: list  # the records that came back without error inside the window
    trace: object  # devtrace.Trace of the traced run, else None
    window_start: float


def banned_modules() -> list:
    """Loaded modules whose whole top-level name is banned."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in BANNED})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``traced`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    out = []
    for m in spec["per_layer"]:
        if (cell in m["workloads"]) if "workloads" in m else (m["moves"] in moved):
            out.append(m)
    return out


def run_cell(config: dict, workload: dict, metrics: list, seed: int, seconds: float,
             traced: bool, device: str, t_proc: float, log=print, control: bool = False) -> dict:
    """One run; returns the result object (the keys of the result line).
    ``control`` also reads the control (the reference one precision below
    the configuration's, in the program's place) over the same work: the
    calibration of a family's limits, never a benchmark run."""
    import torch

    from . import devtrace, families, probe
    from .traffic import clips

    family = families.load(config)
    driver = importlib.import_module(f"{__package__}.traffic.{workload['driver']}")
    mix = workload["mix"]
    pool = clips.make_pool(mix, seed)
    t_in = time.perf_counter()
    ktap = None
    if traced:
        from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

        ktap = probe.KernelTap()
        device_trace.lib()
    built = family.build(config, workload, seed, device)
    engine = built.engine
    tap = family.tap(engine)
    run = Run(engine, tap, mix, pool, seed)
    classes = family.describe(engine)
    t_warm = time.perf_counter()
    if workload.get("warm_requests"):
        driver.drive(run, time.perf_counter() + 600.0, max_requests=workload["warm_requests"])
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_proc
    steps = {"imports and pool": t_in - t_proc, **built.steps,
             "warm requests": time.perf_counter() - t_warm}
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; the engine after warmup() {classes}, after the warm requests "
        f"{family.describe(engine)}")

    t0 = time.perf_counter()
    until = t0 + seconds
    tslice = None
    if traced:
        span = min(workload.get("trace_seconds", seconds), seconds)
        tslice = devtrace.Slice(t0 + (seconds - span) / 2, span, ktap)
    records = driver.drive(run, until, grace_s=GRACE_S)
    if tslice is not None:
        tslice.join(timeout=120.0)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    done = [r for r in records if r.done is not None and r.error is None and r.done <= until]
    failed = [r for r in records if r.done is None or r.error is not None]
    never = [r for r in records if r.done is None]
    broken = [r for r in records if r.error and not r.error.startswith("EngineBusyException")]
    view = View(config, workload, seconds, setup_s, records, done,
                tslice.result if tslice is not None else None, t0)
    values = {}
    for m in metrics:
        v = reader(m["name"]).read(view)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # The program's state goes before the reference runs.
    tap.remove()
    if ktap is not None:
        ktap.remove()
    engine.shutdown()
    del engine, built, run, tap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = [r for r in records if r.done is not None and r.error is None]
    t_judge = time.perf_counter()
    readings = family.judge(judged, config, workload, seed, device, control=control)
    log(f"comparison in {time.perf_counter() - t_judge:.3f} s: "
        + ", ".join(f"{k} {v!r}" for k, v in readings.items())
        + "; requests (sent after the window's start s, wall ms): "
        + " ".join(f"{r.sent - t0:.2f}:{(r.done - r.sent) * 1e3:.0f}" for r in judged))
    limits = workload["check"]["limits"]
    compared = {name: {"value": _finite(readings[name]), "limit": limits[name]}
                for name in limits}
    compared["windows"] = {"value": readings["windows"], "limit": 1}
    compared["never_came_back"] = {"value": len(never), "limit": 0}
    compared["failed_in_error"] = {"value": len(broken), "limit": 0}
    correct = (readings["windows"] >= 1 and not never and not broken
               and all(readings[n] <= lim for n, lim in limits.items()))
    if cuda:
        torch.cuda.empty_cache()
    result = {"correct": bool(correct), "attempted": len(records), "failed": len(failed),
              "metrics": values,
              "device": device_fields(device, memory_peak, view.trace)}
    if traced and view.trace is not None:
        result["breakdown"] = breakdown(view.trace, records)
    if tslice is not None and tslice.error:
        log(f"device trace failed: {tslice.error}")
    if view.trace is not None:
        t = view.trace
        log(f"trace: {t.records} kernel records ({t.dropped} dropped) over {t.window_s:.3f} s, "
            f"busy {t.busy_s:.3f} s; calls counted: "
            + ", ".join(f"{fn}{dims} x{n}" for (fn, dims), n in sorted(t.calls.items()))
            + "; each kernel's calls counted / its records in the trace: "
            + ", ".join(f"{k} {n} / {m}" for k, (n, m) in devtrace.call_record_counts(t).items()))
    result["compared"] = compared
    result["readings"] = readings
    return result


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def device_fields(device: str, memory_peak: int, trace) -> dict:
    import torch

    if device.startswith("cuda"):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(memory_peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def breakdown(trace, records: list) -> dict:
    """The kernels that took the most device time, and the longest idle
    gaps labelled by the benchmark's host spans open during them (each
    request from its send to its return)."""
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:10]
    offset = time.time() - time.perf_counter()
    spans = [("request", r.sent + offset, (r.done or r.sent) + offset)
             for r in records if r.sent is not None]
    gaps = []
    for start, length in trace.gaps:
        end = start + length
        open_ = {}
        for kind, a, b in spans:
            if a <= start and b >= end:
                open_[kind] = open_.get(kind, 0) + 1
        sent = sum(1 for kind, a, _ in spans if start < a < end)
        back = sum(1 for kind, _, b in spans if start < b < end)
        label = " ".join(f"{k}_open={n}" for k, n in sorted(open_.items())) or "nothing_open"
        gaps.append([f"{label} started={sent} ended={back}", length])
    return {"device_ops": [[name, s] for name, s in ops], "idle_gaps": gaps}


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile by ``statistics.quantiles`` (exclusive method)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100)[int(q) - 1]

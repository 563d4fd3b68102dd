#!/usr/bin/env python3
"""Ways to take a device trace of the port's serving engine while a request
runs, measured side by side on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with a CUDA card, ``nvcc``,
``g++`` and PyTorch built for CUDA:

    python3 chip_profile.py            # every route, each in a process of its own
    python3 chip_profile.py ROUTE      # one route, in this process
    python3 chip_profile.py --only ROUTE...  # these routes, each in a process of its own
    python3 chip_profile.py --cupti-probe    # CUPTI's kinds beside CUDA graphs (below)

Large-v3 at full width with random weights (seed 0), int4 cross K/V,
``parallel_requests`` 4, as ``chip_smoke.py`` phase 9 serves it. Each route
runs in a fresh process: an engine and its ``warmup()`` (for the
``torch.profiler`` routes also one empty trace from the main thread, where
kineto registers its client), then a direct 12 s request (beam 5, through
the gang), then a 1 s trace taken on one thread while the same request,
started 0.3 s into the trace, runs on another (as ``/debug/profile``
beside ``/v1/transcribe``). Printed per route: the stop's wait for the
device lock, its hold (the stop itself), the write, the trace's size and
its events by category, the longest stall of a Python thread that ticks
every millisecond during the stop (whether the stop holds the interpreter
lock), and the request's wall against the direct call's. For the
``torch.profiler`` routes the stop is split by the profiler's own
``_stats``: ``profiler_disable_call_duration_us`` (kineto's flush and its
results) against the rest (the device synchronise that opens the stop),
and whether a parse ran in the stop or in the export. Routes (``ROUTES``):

  * ``locked``: CPU and CUDA activities, the engine's ``DeviceLock`` held
    exclusively around the start and the stop;
  * ``locked_cuda``: CUDA activities only, locked as above;
  * ``keep_cupti``: CUDA activities only with kineto told to keep CUPTI
    set up after a stop (``TEARDOWN_CUPTI=0``), locked as above;
  * ``keep_cupti_unlocked``: the same with no lock at all;
  * ``keep_cupti_unlocked_x3``: the same, three traces in one process (a
    stop racing a replay has deadlocked before);
  * ``capped_unlocked``: the same with kineto's device-buffer cap set to
    4 MB (``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB`` through
    ``_ExperimentalConfig(custom_profiler_config=...)``): fewer events;
  * ``kineto_file_cap``: CUDA activities, locked, with the same cap in the
    file kineto reads at start-up (``KINETO_CONFIG``, set before the
    process's first trace);
  * ``cupti_x3``: the port's recorder (``serving/device_trace.py``, the
    route ``/debug/profile`` takes on the card): every kernel through
    CUPTI's activity API, graph launches held back (``GRAPH_LAUNCHES``)
    for the start and the stop only, the JSON written after the stop
    outside the interpreter lock; three traces in one process.

``--cupti-probe`` runs, each in a process of its own, a CUDA graph of 400
small kernels under CUPTI's activity kinds: the recorder's kernel records
beside the graph captured before the trace (its replay time untraced and
traced, the stop and the write); the same after a ``torch.profiler``
trace in the process; and CUPTI's graph-level kind
(``CUPTI_ACTIVITY_KIND_GRAPH_TRACE``, one record per launch) enabled after
the capture, enabled during the capture, and enabled then disabled before
it; then PROBE_STOPS starts and stops of the recorder, 20 ms apart, beside
a thread that launches eager kernels, replays the graph holding
``models.graphs.GRAPH_LAUNCHES`` shared while the start and the stop hold
it exclusively (as ``/debug/profile`` does), or replays it with no gate:
the stop's wait and hold. A case that crashes prints its exit code; one
that outlives ``PROBE_TIMEOUT_S`` deadlocked ("timeout").

A route whose process outlives ``ROUTE_TIMEOUT_S`` dumps its threads' stacks
and is killed (a deadlock). Each reading is printed beside the card's name
and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROUTES = {  # name: (recorder, activities, lock held, environment, kineto config, traces)
    "locked": ("torch", ("CPU", "CUDA"), True, {}, "", 1),
    "locked_cuda": ("torch", ("CUDA",), True, {}, "", 1),
    "keep_cupti": ("torch", ("CUDA",), True, {"TEARDOWN_CUPTI": "0"}, "", 1),
    "keep_cupti_unlocked": ("torch", ("CUDA",), False, {"TEARDOWN_CUPTI": "0"}, "", 1),
    "keep_cupti_unlocked_x3": ("torch", ("CUDA",), False, {"TEARDOWN_CUPTI": "0"}, "", 3),
    "capped_unlocked": ("torch", ("CUDA",), False, {"TEARDOWN_CUPTI": "0"},
                        "ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=4", 1),
    "kineto_file_cap": ("torch", ("CUDA",), True,
                        {"KINETO_CONFIG": "ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=4"}, "", 1),
    "cupti_x3": ("cupti", ("CUDA",), False, {}, "", 3),
}
ROUTE_TIMEOUT_S = 420
TRACE_S = 1.0
CLIP_S = 12.0
PROBE_NODES = 400
PROBE_CASES = ("kernels", "kernels_after_torch_profiler", "stops_beside_eager",
               "stops_beside_gated_replays", "graph_level_after_capture",
               "graph_level_during_capture", "graph_level_toggled_before_capture",
               "stops_beside_replays")
PROBE_TIMEOUT_S = 90  # a probe case that outlives it deadlocked
PROBE_STOPS = 20
GRAPH_TRACE = 51  # CUPTI_ACTIVITY_KIND_GRAPH_TRACE


def empty_torch_trace() -> None:
    """One empty ``torch.profiler`` trace with CUDA activities from this
    thread: kineto's device side registers its client in the thread that
    imported torch, so later traces from other threads record the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


def run_route(name: str) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import PKG, SEED, card_line, voiced_like

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import importlib

    config = importlib.import_module(f"{PKG}.config")
    runtime = importlib.import_module(f"{PKG}.runtime")
    device_trace = importlib.import_module(f"{PKG}.serving.device_trace")

    recorder, activities, locked, env, kineto, traces = ROUTES[name]
    card = card_line()
    settings = config.Settings(
        device="auto", compute_type="int4", enable_vad=True, language="auto",
        model_filename="ggml-large-v3.bin", parallel_requests=4, max_batch_size=4,
        quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
        min_segment_avg_prob=0.0)
    t0 = time.perf_counter()
    engine = runtime.SttEngine(settings, random_init=True)
    engine.warmup()
    t1 = time.perf_counter()
    if recorder == "torch":
        empty_torch_trace()
    else:
        device_trace.lib()  # built and loaded before the trace
    print(f"[{name}] engine and warmup() {t1 - t0:.1f} s; the recorder's set-up "
          f"{time.perf_counter() - t1:.3f} s [{card}]", flush=True)

    x = voiced_like(np.random.default_rng(SEED + 9), CLIP_S)
    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)

    def request() -> float:
        t = time.perf_counter()
        engine.transcribe_pcm16(pcm, 16000, runtime.RequestOptions(should_abort=lambda: False))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    request()
    direct = request()

    acts = [getattr(ProfilerActivity, a) for a in activities]
    lock = engine._device.exclusive
    stalls, ticking = [], threading.Event()

    def ticker():
        last = time.perf_counter()
        while ticking.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            stalls.append(now - last)
            last = now

    timing = {}

    def stopping(stop) -> None:
        """``stop()`` under the lock (when the route takes it), timed, with
        the ticker running."""
        stalls.clear()
        ticking.set()
        tick = threading.Thread(target=ticker)
        tick.start()
        t0 = time.perf_counter()
        if locked:
            with lock():
                t1 = time.perf_counter()
                stop()
                t2 = time.perf_counter()
        else:
            t1 = time.perf_counter()
            stop()
            t2 = time.perf_counter()
        ticking.clear()
        tick.join()
        timing.update(gil_stall_s=max(stalls, default=0.0), wait_s=t1 - t0, hold_s=t2 - t1)

    def trace_torch(path: str) -> None:
        config_ = None
        if kineto:
            from torch._C._profiler import _ExperimentalConfig

            config_ = _ExperimentalConfig(custom_profiler_config=kineto)
        prof = profile(activities=acts, experimental_config=config_)
        if locked:
            with lock():
                prof.start()
        else:
            prof.start()
        time.sleep(TRACE_S)
        stopping(prof.stop)
        stats = prof.profiler._stats
        parsed_in_stop = stats.parse_kineto_call_duration_us
        t2 = time.perf_counter()
        prof.export_chrome_trace(path)
        timing.update(write_s=time.perf_counter() - t2,
                      split=f"kineto's disable {stats.profiler_disable_call_duration_us / 1e6:.3f} s "
                            f"of the stop's {timing['hold_s']:.3f} s; parse {parsed_in_stop / 1e6:.3f} "
                            f"s in the stop, {stats.parse_kineto_call_duration_us / 1e6:.3f} s "
                            f"after the export")

    def trace_cupti(path: str) -> None:
        result = {}

        def stop():
            result["stats"] = device_trace.record(TRACE_S, path)

        # The recorder's start and stop run inside record(), which times them.
        t0 = time.perf_counter()
        stop()
        st = result["stats"]
        timing.update(wait_s=st.wait_s, hold_s=st.stop_s, gil_stall_s=float("nan"),
                      write_s=st.write_s,
                      split=f"the recorder: graph launches held back for the start and the "
                            f"stop (disable and flush), no other lock; {st.kernels} kernel "
                            f"records, {st.dropped} dropped; record() "
                            f"{time.perf_counter() - t0:.3f} s in all")

    path = os.path.join(tempfile.mkdtemp(prefix="sstw_profile_"), "trace.json")
    for n in range(traces):
        walls = []
        tracer = threading.Thread(target=trace_torch if recorder == "torch" else trace_cupti,
                                  args=(path,))
        worker = threading.Thread(target=lambda: walls.append(request()))
        if recorder == "cupti":  # the ticker runs across the whole trace
            stalls.clear()
            ticking.set()
            tick = threading.Thread(target=ticker)
            tick.start()
        tracer.start()
        time.sleep(0.3)
        worker.start()
        tracer.join()
        worker.join()
        if recorder == "cupti":
            ticking.clear()
            tick.join()
            timing["gil_stall_s"] = max(stalls, default=0.0)

        with open(path) as f:
            events = json.load(f)["traceEvents"]
        cats: dict[str, int] = {}
        for ev in events:
            cats[ev.get("cat", "?")] = cats.get(ev.get("cat", "?"), 0) + 1
        size = os.path.getsize(path) / 1e6
        os.remove(path)
        print(f"[{name}] trace {n + 1}/{traces}: recorder {recorder}, activities "
              f"{'+'.join(activities)}, lock {'held' if locked else 'not held'}, env {env}, "
              f"kineto {kineto or '-'}: stop waited {timing['wait_s']:.3f} s, held the device "
              f"{timing['hold_s']:.3f} s, wrote in {timing['write_s']:.3f} s ({timing['split']}); "
              f"the longest stall of a 1 ms Python ticker "
              f"{'during the stop' if recorder == 'torch' else 'over the trace'} "
              f"{timing['gil_stall_s']:.3f} s; trace {size:.1f} MB, {len(events)} events "
              f"{dict(sorted(cats.items(), key=lambda kv: -kv[1]))}; the request inside: "
              f"{walls[0]:.3f} s against the direct call's {direct:.3f} s "
              f"(+{walls[0] - direct:.3f} s) [{card}]", flush=True)
    os.rmdir(os.path.dirname(path))
    engine.shutdown()
    return 0


def probe_case(case: str) -> int:
    """One ``--cupti-probe`` case (see the module docstring)."""
    import contextlib
    import ctypes
    import importlib

    import torch

    from chip_smoke import PKG, card_line

    device_trace = importlib.import_module(f"{PKG}.serving.device_trace")
    lib = device_trace.lib()
    cupti = ctypes.CDLL(str(device_trace.cupti_library()))
    x = torch.randn(512, 512, device="cuda")
    torch.cuda.synchronize()

    def graph():
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the eager warm-up a capture needs
            y = static
            for _ in range(PROBE_NODES):
                y = y * 1.0001
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = static
            for _ in range(PROBE_NODES):
                y = y * 1.0001
        torch.cuda.synchronize()
        return g

    def replay_ms(g, n=50) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            g.replay()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    def counts() -> list:
        c = (ctypes.c_longlong * 4)()
        lib.sstw_trace_counts(c)
        return list(c)

    card = card_line()
    if case.startswith("stops_beside"):
        # PROBE_STOPS starts and stops of the recorder, 20 ms apart, while
        # another thread launches eager kernels or replays a graph: with the
        # replays holding GRAPH_LAUNCHES shared and the start and stop it
        # exclusively, as /debug/profile does, or with no gate.
        graphs_mod = importlib.import_module(f"{PKG}.models.graphs")
        gate = graphs_mod.GRAPH_LAUNCHES
        g = graph() if "replays" in case else None
        done, launched = threading.Event(), [0]

        def launching():
            while not done.is_set():
                if g is None:
                    x.mul_(1.0001)
                elif case == "stops_beside_gated_replays":
                    with gate.shared():
                        g.replay()
                else:
                    g.replay()
                launched[0] += 1
                if launched[0] % 50 == 0:
                    torch.cuda.synchronize()

        other = threading.Thread(target=launching, daemon=True)
        other.start()
        holds = []
        for _ in range(PROBE_STOPS):
            with gate.exclusive() if "gated" in case else contextlib.nullcontext():
                lib.sstw_trace_start()
            time.sleep(0.02)
            t0 = time.perf_counter()
            with gate.exclusive() if "gated" in case else contextlib.nullcontext():
                t1 = time.perf_counter()
                lib.sstw_trace_stop()
                holds.append((t1 - t0, time.perf_counter() - t1))
        done.set()
        other.join()
        print(f"  {PROBE_STOPS} starts and stops beside {launched[0]} launches: the stop's wait "
              f"at most {1e3 * max(w for w, _ in holds):.2f} ms, its hold at most "
              f"{1e3 * max(h for _, h in holds):.2f} ms; the last counts [kernels, other, "
              f"dropped, buffers] {counts()} [{card}]", flush=True)
        return 0
    if case.startswith("kernels"):
        g = graph()
        if case == "kernels_after_torch_profiler":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                g.replay()
                torch.cuda.synchronize()
            print(f"  torch.profiler first: {len(prof.events())} events", flush=True)
        replay_ms(g)
        untraced = min(replay_ms(g) for _ in range(3))
        lib.sstw_trace_start()
        traced = min(replay_ms(g) for _ in range(3))
        t0 = time.perf_counter()
        lib.sstw_trace_stop()
        t1 = time.perf_counter()
        events = lib.sstw_trace_write(os.path.join(tempfile.gettempdir(), "sstw_probe.json").encode())
        t2 = time.perf_counter()
        print(f"  a replay of {PROBE_NODES} kernels: {untraced:.3f} ms untraced, {traced:.3f} ms "
              f"with the recorder on ({1e3 * (traced - untraced) / PROBE_NODES:.3f} us a kernel); "
              f"stop {1e3 * (t1 - t0):.2f} ms, write {1e3 * (t2 - t1):.2f} ms for {events} events "
              f"({1e6 * (t2 - t1) / max(events, 1):.3f} us an event); counts [kernels, other, "
              f"dropped, buffers] {counts()} [{card}]", flush=True)
        return 0
    if case == "graph_level_after_capture":
        g = graph()
        lib.sstw_trace_start()
        print(f"  enable GRAPH_TRACE: {cupti.cuptiActivityEnable(GRAPH_TRACE)}", flush=True)
    elif case == "graph_level_during_capture":
        lib.sstw_trace_start()
        print(f"  enable GRAPH_TRACE: {cupti.cuptiActivityEnable(GRAPH_TRACE)}", flush=True)
        g = graph()
    else:  # toggled before the capture, replayed untraced
        lib.sstw_trace_start()
        print(f"  enable / disable GRAPH_TRACE: {cupti.cuptiActivityEnable(GRAPH_TRACE)} / "
              f"{cupti.cuptiActivityDisable(GRAPH_TRACE)}", flush=True)
        lib.sstw_trace_stop()
        g = graph()
    ms = replay_ms(g, 5)
    cupti.cuptiActivityDisable(GRAPH_TRACE)
    lib.sstw_trace_stop()
    print(f"  five replays, {ms:.3f} ms each; counts [kernels, other (graph launches), dropped, "
          f"buffers] {counts()} [{card}]", flush=True)
    return 0


def run_processes(args_of, names, timeout: float = ROUTE_TIMEOUT_S) -> int:
    rc = 0
    for name in names:
        env = ROUTES[name][3] if name in ROUTES else {}
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            if "KINETO_CONFIG" in env:  # the file kineto reads at start-up
                cfg = os.path.join(tmp, "kineto.conf")
                with open(cfg, "w") as f:
                    f.write(env["KINETO_CONFIG"] + "\n")
                env = {**env, "KINETO_CONFIG": cfg}
            try:
                proc = subprocess.run([sys.executable, __file__, *args_of(name)],
                                      env={**os.environ, **env}, timeout=timeout)
                code = proc.returncode
            except subprocess.TimeoutExpired:
                code = "timeout"
        print(f"[{name}] exit {code} after {time.perf_counter() - t:.1f} s", flush=True)
        rc = rc or (code != 0)
    return int(rc)


def main() -> int:
    import faulthandler

    args = sys.argv[1:]
    if args[:1] == ["--probe-case"]:
        faulthandler.enable()
        return probe_case(args[1])
    if args[:1] == ["--cupti-probe"]:
        run_processes(lambda case: ["--probe-case", case], PROBE_CASES, PROBE_TIMEOUT_S)
        return 0  # a crashing case is a finding, printed with its exit code
    if args and args[0] != "--only":
        faulthandler.dump_traceback_later(ROUTE_TIMEOUT_S - 20, exit=True)
        return run_route(args[0])
    names = [n for n in ROUTES if n in args[1:]] if args[:1] == ["--only"] else list(ROUTES)
    return run_processes(lambda name: [name], names)


if __name__ == "__main__":
    sys.exit(main())

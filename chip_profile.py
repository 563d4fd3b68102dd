#!/usr/bin/env python3
"""Ways to take a ``torch.profiler`` trace of the port's serving engine while
a request runs, measured side by side on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA:

    python3 chip_profile.py            # every route, each in a process of its own
    python3 chip_profile.py ROUTE      # one route, in this process
    python3 chip_profile.py --only ROUTE...  # these routes, each in a process of its own

Large-v3 at full width with random weights (seed 0), int4 cross K/V,
``parallel_requests`` 4, as ``chip_smoke.py`` phase 9 serves it. Each route
runs in a fresh process: an engine, its ``warmup()`` and the one empty trace
``serve()`` takes at start-up, then a direct 12 s request (beam 5, through
the gang), then a 1 s trace taken on one thread while the same request,
started 0.3 s into the trace, runs on another (as ``/debug/profile`` beside
``/v1/transcribe``). Printed per route: the stop's wait for the device
lock, its hold (the stop itself), the export, the trace's size and its
events by category, the longest stall of a Python thread that ticks every
millisecond during the stop (whether the stop holds the GIL), and the
request's wall against the direct call's. Routes (``ROUTES``):

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
    ``_ExperimentalConfig(custom_profiler_config=...)``): fewer events.

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

ROUTES = {  # name: (activities, lock held, environment, kineto config, traces in the process)
    "locked": (("CPU", "CUDA"), True, {}, "", 1),
    "locked_cuda": (("CUDA",), True, {}, "", 1),
    "keep_cupti": (("CUDA",), True, {"TEARDOWN_CUPTI": "0"}, "", 1),
    "keep_cupti_unlocked": (("CUDA",), False, {"TEARDOWN_CUPTI": "0"}, "", 1),
    "keep_cupti_unlocked_x3": (("CUDA",), False, {"TEARDOWN_CUPTI": "0"}, "", 3),
    "capped_unlocked": (("CUDA",), False, {"TEARDOWN_CUPTI": "0"},
                        "ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=4", 1),
}
ROUTE_TIMEOUT_S = 420
TRACE_S = 1.0
CLIP_S = 12.0


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
    http_server = importlib.import_module(f"{PKG}.serving.http_server")

    activities, locked, _, kineto, traces = ROUTES[name]
    card = card_line()
    settings = config.Settings(
        device="auto", compute_type="int4", enable_vad=True, language="auto",
        model_filename="ggml-large-v3.bin", parallel_requests=4, max_batch_size=4,
        quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
        min_segment_avg_prob=0.0)
    t0 = time.perf_counter()
    engine = runtime.SttEngine(settings, random_init=True)
    engine.warmup()
    http_server.init_device_profiler()
    print(f"[{name}] engine, warmup() and the start-up trace in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)

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

    def trace(path: str) -> None:
        config = None
        if kineto:
            from torch._C._profiler import _ExperimentalConfig

            config = _ExperimentalConfig(custom_profiler_config=kineto)
        prof = profile(activities=acts, experimental_config=config)
        if locked:
            with lock():
                prof.start()
        else:
            prof.start()
        time.sleep(TRACE_S)
        stalls.clear()
        ticking.set()
        tick = threading.Thread(target=ticker)
        tick.start()
        t0 = time.perf_counter()
        if locked:
            with lock():
                t1 = time.perf_counter()
                prof.stop()
                t2 = time.perf_counter()
        else:
            t1 = time.perf_counter()
            prof.stop()
            t2 = time.perf_counter()
        ticking.clear()
        tick.join()
        timing["gil_stall_s"] = max(stalls, default=0.0)
        prof.export_chrome_trace(path)
        timing.update(wait_s=t1 - t0, hold_s=t2 - t1, export_s=time.perf_counter() - t2)

    path = os.path.join(tempfile.mkdtemp(prefix="sstw_profile_"), "trace.json")
    for n in range(traces):
        walls = []
        tracer = threading.Thread(target=trace, args=(path,))
        worker = threading.Thread(target=lambda: walls.append(request()))
        tracer.start()
        time.sleep(0.3)
        worker.start()
        tracer.join()
        worker.join()

        with open(path) as f:
            events = json.load(f)["traceEvents"]
        cats: dict[str, int] = {}
        for ev in events:
            cats[ev.get("cat", "?")] = cats.get(ev.get("cat", "?"), 0) + 1
        size = os.path.getsize(path) / 1e6
        os.remove(path)
        print(f"[{name}] trace {n + 1}/{traces}: activities {'+'.join(activities)}, lock "
              f"{'held' if locked else 'not held'}, env {ROUTES[name][2]}, kineto "
              f"{kineto or '-'}: stop waited {timing['wait_s']:.3f} s, held the device "
              f"{timing['hold_s']:.3f} s, exported in {timing['export_s']:.3f} s; the longest "
              f"stall of a 1 ms Python ticker during the stop {timing['gil_stall_s']:.3f} s; trace "
              f"{size:.1f} MB, {len(events)} events "
              f"{dict(sorted(cats.items(), key=lambda kv: -kv[1]))}; the request inside: "
              f"{walls[0]:.3f} s against the direct call's {direct:.3f} s "
              f"(+{walls[0] - direct:.3f} s) [{card}]", flush=True)
    os.rmdir(os.path.dirname(path))
    engine.shutdown()
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] != "--only":
        import faulthandler

        faulthandler.dump_traceback_later(ROUTE_TIMEOUT_S - 20, exit=True)
        return run_route(sys.argv[1])
    rc = 0
    names = [n for n in ROUTES if n in sys.argv[2:]] if "--only" in sys.argv else list(ROUTES)
    for name in names:
        env = ROUTES[name][2]
        t = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable, __file__, name], env={**os.environ, **env},
                                  timeout=ROUTE_TIMEOUT_S)
            code = proc.returncode
        except subprocess.TimeoutExpired:
            code = "timeout"
        print(f"[{name}] exit {code} after {time.perf_counter() - t:.1f} s", flush=True)
        rc = rc or (code != 0)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())

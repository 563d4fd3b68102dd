"""The traced run's device record: a slice of the window recorded with the
port's CUPTI recorder (``serving/device_trace.record``, every kernel,
eager or a node of a graph replay), read back and deleted.

Timestamps: CUPTI stamps kernels on the host's wall clock in nanoseconds,
and host spans are moved onto that clock by one offset. The recorded
interval is from the first kernel's start to the last one's end.

Calls are counted exactly while CUPTI records: from the return of the
recorder's start to the call of its stop (``sstw_trace_start`` and
``sstw_trace_stop`` of the loaded recorder, wrapped for the slice), so the
wait for the start, the stop's flush and the writing of the records after
it count no call whose kernel the trace does not hold. Each kernel of K2,
K3, K4 and K6 is one launch a call, so its calls counted and its records
in the trace can be set side by side (:func:`call_record_counts`).
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
import threading
import time
from collections import defaultdict

_EVENT = re.compile(r'"name": ("(?:[^"\\]|\\.)*"), "pid": \d+, "tid": \d+, '
                    r'"ts": ([0-9.]+), "dur": ([0-9.]+)')


@dataclasses.dataclass
class Trace:
    window_s: float  # the recorded interval
    busy_s: float  # seconds in it with a kernel running
    by_name: dict  # kernel name -> seconds
    count_by_name: dict  # kernel name -> records
    calls: dict  # (library function, sizes) -> calls counted while recording
    gaps: list  # [(start_s, length_s)] idle intervals on the wall clock, longest first
    records: int
    dropped: int


def kernel_name(raw: str) -> str:
    """A demangled kernel name without its return type and arguments."""
    name = raw.encode().decode("unicode_escape") if "\\" in raw else raw
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name[5:] if name.startswith("void ") else name


class Slice:
    """Records ``seconds`` of the device from ``start_at`` (perf_counter)
    in a thread; ``counter`` (a ``probe.KernelTap``) counts calls while it
    records."""

    def __init__(self, start_at: float, seconds: float, counter):
        self.start_at, self.seconds, self.counter = start_at, seconds, counter
        self.result = None
        self.error = None
        self._thread = threading.Thread(target=self._run, name="device-trace", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            time.sleep(max(0.0, self.start_at - time.perf_counter()))
            loaded = device_trace.lib()
            start, stop = loaded.sstw_trace_start, loaded.sstw_trace_stop
            counter = self.counter

            def started():
                code = start()
                counter.active = code == 0
                return code

            def stopping():
                counter.active = False
                return stop()

            counter.take()
            loaded.sstw_trace_start, loaded.sstw_trace_stop = started, stopping
            try:
                t0 = time.time()
                stats = device_trace.record(self.seconds, path)
                t1 = time.time()
            finally:
                loaded.sstw_trace_start, loaded.sstw_trace_stop = start, stop
            self.result = parse(path, t0, t1, counter.take(), stats.dropped)
        except Exception as e:  # noqa: BLE001 — reported as the run's error
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self.counter.active = False
            os.unlink(path)

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)


def parse(path: str, t0: float, t1: float, calls: dict, dropped: int) -> Trace:
    spans = []
    by_name: dict = defaultdict(float)
    count_by_name: dict = defaultdict(int)
    with open(path) as f:
        for line in f:
            m = _EVENT.search(line)
            if m is None:
                continue
            ts, dur = float(m.group(2)) * 1e-6, float(m.group(3)) * 1e-6
            spans.append((ts, ts + dur))
            name = kernel_name(m.group(1)[1:-1])
            by_name[name] += dur
            count_by_name[name] += 1
    spans.sort()
    # The interval is the records' own span: the recorder's start and stop
    # take time on the host that no record can fall in.
    lo, hi = (spans[0][0], max(e for _, e in spans)) if spans else (t0, t1)
    busy, gaps, cur = 0.0, [], None
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur is None:
            gaps.append((lo, s - lo))
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s - cur[1]))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], hi - cur[1]))
    gaps = sorted((g for g in gaps if g[1] > 0), key=lambda g: -g[1])
    return Trace(window_s=hi - lo, busy_s=busy, by_name=dict(by_name),
                 count_by_name=dict(count_by_name), calls=dict(calls),
                 gaps=gaps[:10], records=len(spans), dropped=dropped)


def _named(trace_name: str):
    return re.compile(rf"(^|\W){re.escape(trace_name)}($|<)")


def kernel_seconds(trace: Trace, trace_name: str) -> float:
    """Device seconds of the kernels whose name is ``trace_name`` (any
    template arguments)."""
    pat = _named(trace_name)
    return sum(s for name, s in trace.by_name.items() if pat.search(name))


def call_record_counts(trace: Trace) -> dict:
    """{kernel: (its calls counted, its records in the trace)} for each
    kernel of ``bounds.TRACE_NAMES`` that either saw."""
    from . import bounds

    out = {}
    for kernel, trace_name in bounds.TRACE_NAMES.items():
        calls = sum(n for (fn, _), n in trace.calls.items()
                    if bounds.KERNELS.get(fn, ("",))[0] == kernel)
        pat = _named(trace_name)
        records = sum(n for name, n in trace.count_by_name.items() if pat.search(name))
        if calls or records:
            out[kernel] = (calls, records)
    return out

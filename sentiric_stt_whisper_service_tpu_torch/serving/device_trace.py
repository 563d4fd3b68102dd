"""The device trace behind ``/debug/profile`` on the card: every kernel the
card runs, eager or a node of a CUDA graph replay, recorded through CUPTI's
activity API by the port's own recorder (``csrc/device_trace.cpp``) and
written as a Chrome trace.

``torch.profiler`` records the same kernels but builds its results inside
its stop, holding the interpreter lock, at about 50 us a record, and its
stop deadlocked beside a graph replay in another thread; so the route held
the engine's device lock around it, and a 1 s trace beside a beam decode
held the card for tens of seconds. The recorder copies a few fields of
each record in its buffer callback and writes the JSON after the stop, all
in C outside the interpreter lock (``ctypes`` releases it around each
call). CUPTI's enable, disable and flush deadlocked beside a CUDA graph
launch in another thread, as kineto's stop did: the start and the stop
hold ``models.graphs.GRAPH_LAUNCHES``, which every graph launch holds
shared for its host call only, so they wait for at most one launch a
thread and hold new launches back for the stop's flush (milliseconds a
10,000 records). The engine's device lock is not taken: no device work
waits for a trace's whole length, and the requests beside it pay CUPTI's
timestamps around each kernel while it records and the stop. (CUPTI's graph-level tracing, one record per graph
launch, crashed the launches of graphs instantiated while it was off:
``chip_profile.py --cupti-probe``.)

``record(seconds, path)`` takes one trace (one at a time in the process:
CUPTI's activity state is the process's). The port's tracer (``tracing``)
is on from :data:`LEAD_IN_S` before the recorder's start (so that the spans
under way when it starts are seen) to just after its stop, and at no other
time: its spans and counters of the engine, the batcher, the gang and the
graph captures, and its kernel calls keyed by sizes, belong to the trace.

**One clock.** The records are CUPTI's conversion of the card's timestamps,
which in some processes drifted from the host's clock by 250 to about 2,000
parts per million. So the recorder launches marker kernels at its start,
every :data:`MARK_EVERY_S` of the recording and at its stop, each between
two ``CLOCK_MONOTONIC`` reads (``csrc/device_trace.cpp``): a marker's
record bounds the records' offset from the host's clock from both sides.
The tightest marker of each group gives one point (host time, offset, half
the bracket's width); host spans move onto the records' clock along the
line through the points (:meth:`TraceStats.device_ns`). The join is
checked against the spans before it is trusted: a stage of the engine
synchronises the device at its end, so no record that began before that
synchronise may end after the stage's span (within the points' half
widths). Where a group lacks its point, a point is wider than
:data:`BRACKET_MAX_NS`, or a record fails the check, ``clock_ok`` is false
and the join reads nothing (:meth:`TraceStats.summary`).

After the stop the records' start and end times are copied out;
:meth:`TraceStats.summary` joins them with the spans on its first call
(the card's idle time put down to host work, by role and span, and the
session's counters), and :func:`last` returns the last trace's stats. The
Chrome trace gains the spans and counters as a second process ("host", one
track a thread). The library is built at first
use with ``g++`` into the package's ``_build/`` (named by a hash of the
source, the flags and the CUPTI it binds), never at import. It binds the
CUPTI library that PyTorch loaded (``libcupti.so.12``, found in this
process's mappings) and compiles against the headers beside it, or the
CUDA toolkit's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .. import tracing

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "device_trace.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-Wall")

_lock = threading.Lock()  # the library's build and load
_session = threading.Lock()  # one trace at a time: CUPTI's activity state is the process's
_lib = None
_last = None
HOST_PID = 1 << 20  # the Chrome trace's process of host spans (the card's are device ids)
LEAD_IN_S = 2.0  # the tracer's start before the recorder's
MARK_EVERY_S = 0.25  # a group of marker kernels this often while recording
BRACKET_MAX_NS = 250_000  # the widest half bracket of a clock point the join trusts


@dataclasses.dataclass
class TraceStats:
    """One trace: the seconds its stop waited for the graph launches in
    flight, the seconds it held new ones back (the stop itself: markers,
    disable and flush), the seconds its write took, the events written, the
    kernel records kept, other records skipped, and records dropped (by
    CUPTI, or past the recorder's cap). The clock: ``clock``, one point a
    group of markers (host ns, the records' clock minus the host's, half
    the bracket), ``groups`` (the groups of markers launched), and from the
    points the offset at the start (``offset_ns``), its change by the stop
    (``drift_ns``) and the widest half bracket (``bracket_ns``); ``spans``:
    host spans written into the trace. The tracer's session and the
    records' start and end times (CUPTI's clock) are kept for
    :meth:`summary`."""

    wait_s: float = 0.0
    stop_s: float = 0.0
    write_s: float = 0.0
    events: int = 0
    kernels: int = 0
    other: int = 0
    dropped: int = 0
    offset_ns: int = 0
    drift_ns: int = 0
    bracket_ns: int = 0
    groups: int = 0
    spans: int = 0
    session: object = dataclasses.field(default=None, repr=False)
    starts: object = dataclasses.field(default=None, repr=False)
    ends: object = dataclasses.field(default=None, repr=False)
    clock: tuple = dataclasses.field(default=(), repr=False)
    _summary: dict = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.clock:
            self.offset_ns = self.clock[0][1]
            self.drift_ns = self.clock[-1][1] - self.clock[0][1]
            self.bracket_ns = max(p[2] for p in self.clock)

    def device_ns(self, host_ns):
        """Host monotonic nanoseconds (an int or an int64 array) on the
        records' clock: the offset drawn linearly between the clock's
        points, held at the first and the last beyond them."""
        pts = self.clock
        if not pts:
            return host_ns
        h = np.asarray(host_ns, np.int64)
        t = np.array([p[0] for p in pts], np.int64)
        off = np.array([p[1] for p in pts], np.int64)
        if t.size == 1:
            out = h + off[0]
        else:
            k = np.clip(np.searchsorted(t, h, side="right") - 1, 0, t.size - 2)
            x = np.clip(h, t[0], t[-1]) - t[k]
            out = h + off[k] + x * (off[k + 1] - off[k]) // np.maximum(t[k + 1] - t[k], 1)
        return int(out) if out.ndim == 0 else out

    def check_clock(self, spans) -> dict:
        """Whether the join can trust the clock: a point from the start's
        markers and one from the stop's, each half bracket within
        :data:`BRACKET_MAX_NS`, and no record that began before a stage's
        synchronise ending after the stage's span (``spans``: moved, with
        ``sync``), within the widest half bracket. ``step_ns``: the largest
        move of the offset between two points (CUPTI's conversion has
        stepped by milliseconds within a second; a span between those two
        points may sit off by up to that)."""
        pts = self.clock
        tight = bool(pts) and self.bracket_ns <= BRACKET_MAX_NS
        ends_held = len(pts) >= 2 and {pts[0][3], pts[-1][3]} == {0, self.groups - 1}
        checked = late = 0
        if self.starts is not None and len(self.starts):
            order = np.argsort(self.starts, kind="stable")
            begun = self.starts[order]
            reach = np.maximum.accumulate(self.ends[order])
            tol = self.bracket_ns
            for sp in spans:
                if sp.sync is None:
                    continue
                i = int(np.searchsorted(begun, sp.sync - tol, side="left"))
                if i == 0:
                    continue
                checked += 1
                late += int(reach[i - 1] > sp.end + tol)
        step = max((abs(b[1] - a[1]) for a, b in zip(pts, pts[1:])), default=0)
        return dict(ok=tight and ends_held and late == 0, points=len(pts), groups=self.groups,
                    offset_ns=self.offset_ns, drift_ns=self.drift_ns,
                    bracket_ns=self.bracket_ns, step_ns=step, sync_checked=checked,
                    sync_late=late)

    def summary(self) -> dict:
        """The join of the session's spans with the kernel records, on its
        first call: ``clock`` (:meth:`check_clock`), ``idle``
        (``tracing.attribute_idle``: the interval, the idle seconds by role
        and by innermost span, unseen, "no program work"; None unless the
        clock is trusted), ``counters`` (``tracing.counters_of``: live slots
        per batcher step, admissions per tick, members per gang decode, the
        ``_eager`` wait per request thread; the host's clock alone),
        ``calls`` (keyed kernel calls), the spans and counters kept and
        dropped, and the join's seconds. Empty without a session."""
        if self._summary is None:
            sess = self.session
            if sess is None:
                self._summary = {}
                return self._summary
            t0 = time.perf_counter()
            spans = [_Moved(sp, self) for sp in sess.spans]
            starts = self.starts if self.starts is not None else np.zeros(0, np.int64)
            ends = self.ends if self.ends is not None else np.zeros(0, np.int64)
            clock = self.check_clock(spans)
            self._summary = dict(
                clock=clock,
                idle=tracing.attribute_idle(starts, ends, spans) if clock["ok"] else None,
                counters=tracing.counters_of(sess), calls=dict(sess.calls),
                spans=len(sess.spans), counted=len(sess.counters), dropped=sess.dropped,
                join_s=time.perf_counter() - t0)
        return self._summary


class _Moved:
    """A span's fields for the join, its times on the records' clock."""

    __slots__ = ("thread", "start", "end", "kind", "role", "name", "sync")

    def __init__(self, sp, stats: TraceStats):
        self.thread, self.kind, self.role, self.name = sp.thread, sp.kind, sp.role, sp.name
        self.start, self.end = stats.device_ns(sp.start), stats.device_ns(sp.end)
        sync = sp.attrs.get("sync")
        self.sync = None if sync is None else stats.device_ns(sync)


def clock_points(rows) -> tuple:
    """The clock's points from the markers' rows (group, host ns before the
    launch and after the synchronise, the record's start and end): per
    group, of the markers whose record fits their bracket, the one with the
    narrowest feasible offset, as (host ns, offset, half width, group)."""
    best: dict = {}
    for group, before, after, start, end in rows:
        lo, hi = end - after, start - before  # the offsets the marker allows
        if hi < lo:
            continue
        if group not in best or hi - lo < best[group][1] - best[group][0]:
            best[group] = (lo, hi, (before + after) // 2)
    return tuple((mid, lo + (hi - lo) // 2, (hi - lo + 1) // 2, g)
                 for g, (lo, hi, mid) in sorted(best.items()))


def last() -> TraceStats | None:
    """The stats of the last trace this process took (None before one)."""
    return _last


def describe(stats: TraceStats) -> str:
    """One line of the trace's join: the card's idle share put down to the
    workers, the request threads, unseen threads and no program work, the
    top spans, the counters and the clock."""
    s = stats.summary()
    if not s:
        return "no host spans"
    idle, c, clock = s["idle"], s["counters"], s["clock"]

    def num(x, f):
        return "n/a" if x is None else format(x, f)

    if idle is None:
        head = "idle not put down to host work: the clock is not trusted"
    else:
        w = idle["window_s"] or 1.0
        top = ", ".join(f"{k} {100 * v / w:.1f} %" for k, v in list(idle["by_span"].items())[:5])
        head = (f"idle {100 * idle['idle_s'] / w:.1f} % of {idle['window_s']:.3f} s: workers "
                f"{100 * idle['by_role'].get(tracing.WORKER, 0.0) / w:.1f} %, requests "
                f"{100 * idle['by_role'].get(tracing.REQUEST, 0.0) / w:.1f} %, unseen "
                f"{100 * idle['unseen_s'] / w:.1f} %, no program work "
                f"{100 * idle['no_program_work_s'] / w:.1f} % (top: {top or 'none'})")
    return (f"{head}; live slots {num(c['live_slots'], '.2f')} over {c['batcher_steps']} "
            f"steps; {c['batcher_admitted']} admitted over {c['batcher_ticks']} batcher ticks; "
            f"gang members {num(c['gang_members'], '.2f')} over {c['gang_decodes']} decodes; "
            f"eager wait {num(c['eager_wait_ms'], '.1f')} ms a request thread over "
            f"{c['request_threads']}; {sum(s['calls'].values())} kernel calls keyed; "
            f"{s['spans']} spans, {s['counted']} counters, {s['dropped']} dropped; clock "
            f"{'trusted' if clock['ok'] else 'NOT trusted'}: {clock['points']} points of "
            f"{clock['groups']} marker groups, offset {clock['offset_ns']} ns, drift "
            f"{clock['drift_ns']} ns, bracket ±{clock['bracket_ns']} ns, largest step "
            f"{clock['step_ns']} ns, "
            f"{clock['sync_late']} of {clock['sync_checked']} stage synchronises late; "
            f"joined in {s['join_s']:.3f} s")


def cupti_library() -> Path:
    """The CUPTI library mapped into this process (PyTorch's own, loaded
    with it); raises where there is none."""
    import torch  # noqa: F401  (loads libcupti with its profiler)

    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "/libcupti.so" in path:
                return Path(path)
    raise RuntimeError("device trace: no libcupti in this process (PyTorch without CUPTI)")


def _include_dirs(cupti: Path) -> list[Path]:
    cuda = Path(os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda")
    dirs = [d for d in (cupti.parent.parent / "include", cuda / "extras" / "CUPTI" / "include")
            if (d / "cupti.h").is_file()]
    return dirs + [cuda / "include"]


def build() -> Path:
    """Compile the recorder for this process's CUPTI, unless this source,
    these flags and that library were built already; returns the library."""
    cupti = cupti_library()
    includes = _include_dirs(cupti)
    args = [*CXX_FLAGS, *(f"-I{d}" for d in includes), str(SOURCE), f"-L{cupti.parent}",
            f"-l:{cupti.name}", f"-Wl,-rpath,{cupti.parent}"]
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(args).encode()).hexdigest()
    out = BUILD_DIR / f"libsstw_trace-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([os.environ.get("CXX", "g++"), *args, "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"device trace: g++ failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded recorder, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name in ("sstw_trace_start", "sstw_trace_stop"):
                getattr(loaded, name).argtypes = []
                getattr(loaded, name).restype = ctypes.c_int
            loaded.sstw_trace_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
            loaded.sstw_trace_counts.restype = None
            loaded.sstw_trace_write.argtypes = [ctypes.c_char_p]
            loaded.sstw_trace_write.restype = ctypes.c_longlong
            loaded.sstw_trace_error.argtypes = [ctypes.c_int]
            loaded.sstw_trace_error.restype = ctypes.c_char_p
            loaded.sstw_trace_device.argtypes = [ctypes.c_int]
            loaded.sstw_trace_device.restype = None
            loaded.sstw_trace_mark.argtypes = []
            loaded.sstw_trace_mark.restype = ctypes.c_int
            loaded.sstw_trace_marks.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                                ctypes.c_longlong]
            loaded.sstw_trace_marks.restype = ctypes.c_longlong
            loaded.sstw_trace_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_longlong]
            loaded.sstw_trace_copy.restype = ctypes.c_longlong
            _lib = loaded
    return _lib


def _check(loaded, what: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"device trace: {what}: CUPTI error {code} "
                           f"({loaded.sstw_trace_error(code).decode()})")


def prebuild() -> None:
    """Build and load the recorder now (``serve()`` on the card calls it in
    a thread at its start, so that the first ``/debug/profile`` does not pay
    the build); a failure is logged, and the first trace raises it again."""
    try:
        lib()
    except Exception as e:  # noqa: BLE001 — reported by the first trace
        import logging

        logging.getLogger(__name__).warning("device trace: the recorder did not build: %s", e)


def _device() -> int:
    """The calling thread's CUDA device (0 without one)."""
    import torch

    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def record(seconds: float, path: str) -> TraceStats:
    """Trace the card for ``seconds`` and write the Chrome trace to
    ``path``; the device and every other thread run on meanwhile. The
    tracer is on from :data:`LEAD_IN_S` before the start to just after the
    stop. The start, each group of markers while recording and the stop
    hold ``models.graphs.GRAPH_LAUNCHES`` exclusively: each waits for the
    graph launches and captures in flight (a launch is one host call) and
    holds new ones back while it runs."""
    global _last
    from ..models.graphs import GRAPH_LAUNCHES

    loaded = lib()
    loaded.sstw_trace_device(_device())
    with _session:
        sess = tracing.start()
        try:
            time.sleep(LEAD_IN_S)
            with GRAPH_LAUNCHES.exclusive():
                _check(loaded, "start", loaded.sstw_trace_start())
            groups = 1
            began = time.perf_counter_ns()
            try:
                deadline = time.perf_counter() + seconds
                while deadline - time.perf_counter() > 1.5 * MARK_EVERY_S:
                    time.sleep(MARK_EVERY_S)
                    with GRAPH_LAUNCHES.exclusive():
                        groups += loaded.sstw_trace_mark() == 0
                time.sleep(max(0.0, deadline - time.perf_counter()))
            finally:
                t0 = time.perf_counter()
                with GRAPH_LAUNCHES.exclusive():
                    t1 = time.perf_counter()
                    sess.slice_ns = (began, time.perf_counter_ns())
                    _check(loaded, "stop", loaded.sstw_trace_stop())
                    t2 = time.perf_counter()
                groups += 1
        finally:
            sess = tracing.stop()
        events = loaded.sstw_trace_write(str(path).encode())
        counts = (ctypes.c_longlong * 4)()
        loaded.sstw_trace_counts(counts)
        marks = np.zeros((8 * groups, 5), np.int64)  # 8 markers at each end, fewer between
        n_marks = loaded.sstw_trace_marks(
            marks.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(marks))
        starts = np.zeros(counts[0], np.uint64)
        ends = np.zeros(counts[0], np.uint64)
        n = loaded.sstw_trace_copy(starts.ctypes.data, ends.ctypes.data, counts[0])
        stats = TraceStats(
            stop_s=t2 - t1, wait_s=t1 - t0, events=int(events), kernels=counts[0],
            other=counts[1], dropped=counts[2], groups=groups, session=sess,
            starts=starts[:n].astype(np.int64), ends=ends[:n].astype(np.int64),
            clock=clock_points(marks[:n_marks].tolist()))
        if events >= 0:
            stats.spans = _write_host_spans(path, stats, events)
        stats.write_s = time.perf_counter() - t2
    if events < 0:
        raise OSError(f"device trace: could not write {path}")
    _last = stats
    return stats


def _write_host_spans(path: str, stats: TraceStats, events: int) -> int:
    """Append the session's spans (complete events) and counters (instant
    events, their values as arguments) to the Chrome trace at ``path`` as
    the process "host", one track a thread, on the records' clock; returns
    the spans written. Their keys come in another order than the kernels'
    (``ts`` before ``pid``), so a reader of kernel events that matches the
    recorder's key order takes none of them."""
    sess = stats.session
    if sess is None or not (sess.spans or sess.counters):
        return 0
    idents = set(sess.threads) | {c[2] for c in sess.counters}
    tids = {ident: i + 1 for i, ident in enumerate(sorted(idents))}
    lines = [json.dumps({"ph": "M", "pid": HOST_PID, "name": "process_name",
                         "args": {"name": "host"}})]
    lines += [json.dumps({"ph": "M", "pid": HOST_PID, "tid": tid, "name": "thread_name",
                          "args": {"name": sess.threads.get(ident, str(ident))}})
              for ident, tid in tids.items()]

    def ts(ns: int) -> str:
        return f"{ns // 1000}.{ns % 1000:03d}"

    for sp in sess.spans:
        t = int(stats.device_ns(sp.start))
        d = max(0, int(stats.device_ns(sp.end)) - t)
        args = {"kind": sp.kind, "role": sp.role, "request": sp.request, "id": sp.id,
                "parent": sp.parent, **({"open": True} if sp.open else {}), **sp.attrs}
        lines.append(
            f'{{"ph": "X", "cat": "host", "ts": {ts(t)}, "dur": {ts(d)}, "pid": {HOST_PID}, '
            f'"tid": {tids.get(sp.thread, 0)}, "name": {json.dumps(sp.name)}, '
            f'"args": {json.dumps(args, default=list)}}}')
    for name, t_ns, thread, _, request, values in sess.counters:
        args = {"request": request, **values}
        lines.append(
            f'{{"ph": "i", "s": "t", "cat": "counter", "ts": {ts(int(stats.device_ns(t_ns)))}, '
            f'"pid": {HOST_PID}, "tid": {tids.get(thread, 0)}, "name": {json.dumps(name)}, '
            f'"args": {json.dumps(args, default=list)}}}')
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - 64))
        tail = f.read()
        close = tail.rfind(b"]")
        if close < 0:
            return 0
        f.seek(size - len(tail) + close)
        f.truncate()
        f.write(((",\n" if events else "\n") + ",\n".join(lines) + "\n]}\n").encode())
    return len(sess.spans)

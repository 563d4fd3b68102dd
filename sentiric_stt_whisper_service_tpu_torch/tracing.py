"""The port's spans and counters: what the engine's request threads, the
continuous batcher's and the beam gang's workers, the graph captures and
the kernel library were doing, recorded in memory while a device trace
records, and put beside the trace's kernel records on one clock.

**When.** ``serving/device_trace.record`` turns the tracer on a lead-in
before the recorder's start (:func:`start`), so that the threads' spans
under way when the recording starts are seen, and off just after its stop
(:func:`stop`); at no other time is it on, and no setting or environment
variable turns it on. Off, a span site costs the read of the module flag
:data:`on`: it makes no span, reads no clock and takes no lock. Sites read::

    with tracing.begin("vad") if tracing.on else tracing.OFF:
        ...

(a :class:`Span` closes itself at the block's end, also on an exception;
:data:`OFF` is one shared object that does nothing.)

**What.** A span has a name, a kind (``work``: the thread does the
program's work; ``wait``: it waits for a lock, a queue, a future or the
device), the thread, the thread's role (``worker`` for the threads that
run inside :class:`worker_role`, the batcher's and the gang's; ``request`` for
every other), the request it serves (the id of the ``request`` span open on
its thread; a worker's spans carry the ids of the requests they serve in
their ``requests`` attribute), its parent (the span open on the same thread
when it began), its start and end from ``time.perf_counter_ns()``
(``CLOCK_MONOTONIC``) and a few attributes. A counter is a name, an instant
and a few integers. While on, the kernel library's calls are also counted
by (library function, size arguments) (:func:`add_call`,
``kernels.call``), a graph replay adding the calls its capture made
(:func:`add_calls`, summed at the stop).

A session keeps at most :data:`CAP` spans and counters and counts the rest
as dropped. A span is kept when it ends inside the session; at the stop,
the spans still open on every thread are kept too, cut at the stop and
marked ``open``. A span that began before the start is not seen at all: a
thread's time before its first span of the session is "unseen" in the
join; a counter is taken at one instant, so one that ends a piece of work
(a gang's decode) counts that work whenever it began.

**The join** (:func:`attribute_idle`, read after the session): over the
interval of the device trace's kernel records (the first start to the last
end), each instant with no kernel running is split evenly among the
threads whose innermost open span is a ``work`` span; an instant with none
is "unseen" if some thread has not yet begun its first span, else "no
program work" (every thread waits or is outside the program). This gives
the card's idle seconds by role and by innermost span, beside the
session's counters (:func:`counters_of`).
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter_ns

WORK, WAIT = "work", "wait"
REQUEST, WORKER = "request", "worker"
CAP = 1 << 20  # spans and counters one session keeps

on = False  # the flag every span site reads
_session = None
_ids = itertools.count(1)
_local = threading.local()
_threads: dict = {}  # ident -> _Thread, the threads with spans open since the last stop


class Span:
    """An open or closed span; as a context manager it closes itself."""

    __slots__ = ("id", "parent", "name", "kind", "thread", "role", "request", "start", "end",
                 "attrs", "session", "open")

    def __init__(self, sid, parent, name, kind, thread, role, request, start, session):
        self.id, self.parent, self.name, self.kind = sid, parent, name, kind
        self.thread, self.role, self.request, self.start = thread, role, request, start
        self.end = None
        self.attrs = {}
        self.session = session
        self.open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end(self)
        return False


class _Off:
    """A span site's block while the tracer is off: yields None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Thread:
    __slots__ = ("ident", "name", "role", "request", "stack")

    def __init__(self):
        me = threading.current_thread()
        self.ident, self.name = me.ident, me.name
        self.role, self.request, self.stack = REQUEST, 0, []


class Session:
    """One device trace's spans, counters and keyed kernel calls."""

    def __init__(self):
        self.spans: list = []
        self.counters: list = []  # (name, t_ns, thread, role, request, values)
        self.calls: dict = {}  # (library function, sizes) -> calls (replays summed at the stop)
        self.threads: dict = {}  # ident -> thread name
        self.dropped = 0
        self.closed = False
        self.start_ns = perf_counter_ns()
        self.stop_ns = None
        self.slice_ns = None  # (start, stop) of the device trace's recording, host ns
        self._replays: dict = {}  # id(keyed calls of a capture) -> [those calls, replays]
        self._lock = threading.Lock()

    def _keep(self, into: list, rec) -> None:
        if len(self.spans) + len(self.counters) < CAP:
            into.append(rec)
        else:
            with self._lock:
                self.dropped += 1


def _thread() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
    return st


class worker_role:
    """Inside it the calling thread's spans have the role ``worker`` (a
    worker's loop runs in it)."""

    def __enter__(self):
        st = _thread()
        self._was, st.role = st.role, WORKER
        return self

    def __exit__(self, *exc):
        _thread().role = self._was
        return False


def start() -> Session:
    """A new session; spans and counters are kept from here."""
    global on, _session
    _session = Session()
    on = True
    return _session


def stop() -> Session:
    """End the session: nothing more is kept; the spans open on every thread
    are kept cut at this instant, marked ``open``."""
    global on, _session
    on = False
    sess, _session = _session, None
    if sess is None:
        return Session()
    sess.stop_ns = perf_counter_ns()
    sess.closed = True
    with sess._lock:
        for keyed, n in sess._replays.values():
            for key, k in keyed.items():
                sess.calls[key] = sess.calls.get(key, 0) + k * n
        sess._replays.clear()
    for ident, st in list(_threads.items()):
        if not st.stack:
            _threads.pop(ident, None)
        for sp in list(st.stack):
            if sp.session is sess and sp.end is None:
                cut = Span(sp.id, sp.parent, sp.name, sp.kind, sp.thread, sp.role, sp.request,
                           sp.start, sess)
                cut.end, cut.open, cut.attrs = sess.stop_ns, True, dict(sp.attrs)
                sess.threads.setdefault(sp.thread, st.name)
                sess.spans.append(cut)
    return sess


def begin(name: str, kind: str = WORK, at: int | None = None) -> Span:
    """Open a span on the calling thread (``at``: its start, else now)."""
    st = _thread()
    stack = st.stack
    if not stack:
        _threads[st.ident] = st
    sp = Span(next(_ids), stack[-1].id if stack else 0, name, kind, st.ident, st.role,
              st.request, perf_counter_ns() if at is None else at, _session)
    stack.append(sp)
    return sp


def begin_request() -> Span:
    """Open the calling thread's ``request`` span: its id is the request id
    of every span the request causes, here and in the workers."""
    sp = begin("request")
    sp.request = _thread().request = sp.id
    return sp


def end(sp: Span, at: int | None = None) -> None:
    """Close ``sp`` (``at``: its end, else now); kept if its session is
    still on."""
    sp.end = perf_counter_ns() if at is None else at
    st = _thread()
    stack = st.stack
    if stack and stack[-1] is sp:
        stack.pop()
    elif sp in stack:
        stack.remove(sp)
    if sp.name == "request" and st.request == sp.id:
        st.request = 0
    sess = sp.session
    if sess is not None and not sess.closed:
        sess.threads.setdefault(st.ident, st.name)
        sess._keep(sess.spans, sp)


def request_id() -> int:
    """The id of the request the calling thread serves (0 for none)."""
    return _thread().request


def count(name: str, **values) -> None:
    """A counter: ``values`` (integers, or tuples of request ids) now."""
    sess = _session
    if sess is None:
        return
    st = _thread()
    sess._keep(sess.counters, (name, perf_counter_ns(), st.ident, st.role, st.request, values))


def add_call(key: tuple) -> None:
    """One kernel call at ``key`` (library function, sizes)."""
    sess = _session
    if sess is not None:
        with sess._lock:
            sess.calls[key] = sess.calls.get(key, 0) + 1


def add_calls(keyed: dict) -> None:
    """The calls of a graph's capture, once per replay: the replay is
    counted, and :func:`stop` adds ``keyed`` that many times (``keyed`` is
    the capture's own dict, left unchanged)."""
    sess = _session
    if sess is not None and keyed:
        with sess._lock:
            entry = sess._replays.get(id(keyed))
            if entry is None:
                sess._replays[id(keyed)] = [keyed, 1]
            else:
                entry[1] += 1


class Gate:
    """A lock whose every acquisition is a ``wait`` span named ``name``
    while the tracer is on (the engine's ``_eager``)."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock, self.name = lock, name

    def __enter__(self):
        if on:
            sp = begin(self.name, WAIT)
            try:
                self._lock.acquire()
            finally:
                end(sp)
        else:
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


# ----------------------------------------------------------------------
# The join
# ----------------------------------------------------------------------

def _idle_gaps(starts, ends):
    """(lo, hi, gap starts, gap ends): the records' interval and the
    instants in it with no kernel running, as sorted disjoint intervals."""
    import numpy as np

    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    lo, hi = s[0], e.max()
    reach = np.maximum.accumulate(e)
    at = np.nonzero(s[1:] > reach[:-1])[0]
    return lo, hi, reach[at], s[at + 1]


def _innermost(spans):
    """Per thread, the stretches in which its innermost open span is one
    span: [(start, end, span)], from its spans (well nested per thread)."""
    by_thread: dict = {}
    for sp in spans:
        by_thread.setdefault(sp.thread, []).append(sp)
    out = []
    for group in by_thread.values():
        events = []
        for i, sp in enumerate(group):
            # At one instant: ends before starts, the inner end first, the
            # outer start first.
            events.append((sp.start, 1, -sp.end, i))
            events.append((sp.end, 0, -sp.start, i))
        events.sort()
        stack: list = []
        last = None
        for t, is_start, _, i in events:
            if stack and last is not None and t > last:
                out.append((last, t, group[stack[-1]]))
            if is_start:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            last = t
    return out


def attribute_idle(starts, ends, spans) -> dict:
    """The card's idle time over the kernel records' interval, split evenly
    among the threads whose innermost open span is a ``work`` span at each
    instant. ``starts``/``ends``: the records' times (ns, int64); ``spans``:
    objects with ``thread``, ``start``, ``end`` (ns, the records' clock),
    ``kind``, ``role`` and ``name``. Returns seconds: ``window_s``,
    ``idle_s``, ``by_role`` {role: s}, ``by_span`` {"role/name": s},
    ``unseen_s`` (idle with no thread in work while some thread has not yet
    begun its first span) and ``no_program_work_s`` (the rest)."""
    import numpy as np

    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    empty = dict(window_s=0.0, idle_s=0.0, by_role={}, by_span={}, unseen_s=0.0,
                 no_program_work_s=0.0)
    if starts.size == 0:
        return empty
    lo, hi, gs, ge = _idle_gaps(starts, ends)
    if gs.size == 0:
        return dict(empty, window_s=float(hi - lo) * 1e-9)
    gs, ge = (gs - lo).astype(np.float64), (ge - lo).astype(np.float64)
    idle_s = float((ge - gs).sum()) * 1e-9
    before = np.concatenate(([0.0], np.cumsum(ge - gs)))  # idle before gap k

    def idle_until(t):
        """Idle ns in [lo, lo + t] for each t."""
        t = np.asarray(t, np.float64)
        k = np.searchsorted(gs, t, side="right") - 1
        part = np.where(k >= 0, np.clip(t - gs[np.maximum(k, 0)], 0.0,
                                        (ge - gs)[np.maximum(k, 0)]), 0.0)
        return np.where(k >= 0, before[np.maximum(k, 0)], 0.0) + part

    closed = [sp for sp in spans if sp.end is not None and sp.end > sp.start]
    segs = [(a - lo, b - lo, sp) for a, b, sp in _innermost(closed)
            if sp.kind == WORK and b > lo and a < hi]
    first: dict = {}  # thread -> its first span's start
    for sp in closed:
        first[sp.thread] = min(first.get(sp.thread, sp.start), sp.start)
    unseen = [f - lo for f in first.values() if f > lo]
    width = float(hi - lo)
    a = np.clip(np.array([s[0] for s in segs], np.float64), 0.0, width)
    b = np.clip(np.array([s[1] for s in segs], np.float64), 0.0, width)
    u = np.clip(np.array(unseen, np.float64), 0.0, width)
    # The counts of threads in work and of threads unseen, piecewise constant.
    times = np.concatenate((a, b, np.zeros(u.size), u, [0.0, width]))
    work = np.concatenate((np.ones(a.size), -np.ones(b.size), np.zeros(2 * u.size + 2)))
    hidden = np.concatenate((np.zeros(a.size + b.size), np.ones(u.size), -np.ones(u.size),
                             [0.0, 0.0]))
    order = np.argsort(times, kind="stable")
    times, work, hidden = times[order], work[order], hidden[order]
    ut, first_at = np.unique(times, return_index=True)
    last_at = np.r_[first_at[1:] - 1, times.size - 1]
    n_work = np.cumsum(work)[last_at][:-1]  # over [ut[i], ut[i + 1])
    n_hidden = np.cumsum(hidden)[last_at][:-1]
    idle_in = np.diff(idle_until(ut))
    unseen_s = float(idle_in[(n_work <= 0) & (n_hidden > 0)].sum()) * 1e-9
    by_role: dict = {}
    by_span: dict = {}
    if segs:
        # Idle shared per thread in work, accumulated over time.
        share = np.where(n_work > 0, idle_in / np.maximum(n_work, 1), 0.0)
        acc = np.concatenate(([0.0], np.cumsum(share)))
        got = acc[np.searchsorted(ut, b)] - acc[np.searchsorted(ut, a)]
        for (_, _, sp), ns in zip(segs, got.tolist()):
            if ns <= 0:
                continue
            s = ns * 1e-9
            by_role[sp.role] = by_role.get(sp.role, 0.0) + s
            key = f"{sp.role}/{sp.name}"
            by_span[key] = by_span.get(key, 0.0) + s
    given = sum(by_role.values())
    return dict(window_s=width * 1e-9, idle_s=idle_s, by_role=by_role,
                by_span=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
                unseen_s=unseen_s, no_program_work_s=max(0.0, idle_s - given - unseen_s))


def counters_of(sess: Session) -> dict:
    """The session's means, with the numbers they are means of, over the
    device trace's recording (``sess.slice_ns``, else the whole session):
    live slots per batcher step (``live_slots``, Σ live × steps / Σ steps
    over the chunks that ended in it), admissions per batcher tick
    (``batcher_admitted`` over ``batcher_ticks``), real windows per gang
    decode (``gang_members``, over the decodes that ended in it) and the
    milliseconds each request thread spent waiting for the engine's
    ``_eager`` in it (``eager_wait_ms``: the ``eager`` wait spans' time
    inside the recording over the request threads with a span in it)."""
    lo, hi = sess.slice_ns or (sess.start_ns, sess.stop_ns or sess.start_ns)
    steps = live = admitted = ticks = 0
    members = []
    for name, t, _, _, _, values in sess.counters:
        if not lo <= t <= hi:
            continue
        if name == "batcher.chunk":
            steps += values["steps"]
            live += values["live"] * values["steps"]
        elif name == "batcher.admit":
            admitted += values["admitted"]
        elif name == "gang.decode":
            members.append(values["members"])
    waited = 0
    threads = set()
    for sp in sess.spans:
        if sp.end < lo or sp.start > hi:
            continue
        if sp.name == "batcher.tick" and lo <= sp.end <= hi:
            ticks += 1
        if sp.role == REQUEST:
            threads.add(sp.thread)
            if sp.name == "eager":
                waited += min(sp.end, hi) - max(sp.start, lo)
    return dict(
        live_slots=live / steps if steps else None, batcher_steps=steps,
        batcher_admitted=admitted, batcher_ticks=ticks,
        gang_members=sum(members) / len(members) if members else None,
        gang_decodes=len(members),
        eager_wait_ms=waited / len(threads) * 1e-6 if threads else None,
        request_threads=len(threads))

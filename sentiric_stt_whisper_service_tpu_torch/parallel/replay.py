"""The ordered channel of device operations: the port's counterpart of the
JAX package's single controller over a mesh.

The JAX engine is one process that drives every device of its mesh through
GSPMD. Here each process drives one device (``parallel/mesh.py``), so the
engine runs one process per device: rank 0 serves (its servers, request
threads, the batcher's and the gang's workers, every host decision), and
every other rank builds the same engine on its shard and *follows*. Each
device operation that rank 0 starts (an encode, a decode, a batcher tick,
...) is a named op of this channel:

  * rank 0 runs ``call(name, *args)``: it takes the process-wide order lock,
    broadcasts ``(name, args)`` to every other rank over a gloo group of the
    channel's own, runs the op, and releases the lock when the op, and so its
    collectives, are done;
  * the other ranks run ``follow()``: they receive each op in order and run
    it with rank 0's host arguments on their own shard, until ``close()``
    sends ``stop``.

The group is the channel's own, so that its broadcasts of host objects never
interleave with the tensor collectives of the tp and sp groups, and it has a
short timeout (``TIMEOUT_S``, 120 s; gloo's default is 30 minutes): a rank
that dies makes the others fail, not hang. Once the engine is built on
every rank (``open()``), a keep-alive op goes out whenever rank 0 has sent
nothing for a quarter of the timeout, so an idle service keeps its
followers.

**Decisions.** Rank 0 alone decides what changes which collectives run next,
and sends it: ``decide(fn)`` inside an op runs ``fn()`` on rank 0 and
broadcasts its answer, which every other rank returns without calling its
own ``fn``. ``models/graphs.run_window`` routes a window's stop through the
channel of the op running on its thread (``current()``); the engine, the
batcher and the gang route their aborts (``decider``); the batcher's
admissions, evictions and abort polls and the gang's membership and bucket
are op arguments.

**Handles.** A device value that outlives its op (a window's cross K/V, which
a later decode or alignment pass reads) is ``keep()``-ed inside the op on
every rank, under the same handle: each rank numbers its kept values in op
order, so the numbers agree. Rank 0 gets a :class:`Held` (the value, marked
with its handle); an op argument that is a ``Held`` travels as its handle and
each follower reads its own value from its table. When rank 0 drops a
``Held`` its handle is freed on the followers with the next message
(``flush()`` sends one at once).

Ops nest: an op called inside an op (on rank 0, or on a follower replaying)
runs in place, since the outer op carries it. Exceptions: an op that raises
on rank 0 raises to its caller; a follower logs the same exception of its
replay and goes on, so a failure that every rank meets alike (a refused
argument) leaves them in step. A follower whose channel fails (a dead rank
0, a timeout) raises out of ``follow()``.

Without a process group (mesh "1") the channel runs each op in place and
sends nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import threading
import time
import weakref
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

TIMEOUT_S = 120.0
_STOP = "stop"
_NOOP = "noop"

_current = threading.local()  # .channel: the Replay whose op runs on this thread


def current() -> Optional["Replay"]:
    """The channel whose op runs on this thread (None outside an op, and
    on a channel without a group)."""
    return getattr(_current, "channel", None)


class Held(dict):
    """Rank 0's view of a kept device value (a dict of tensors, a window's
    cross K/V): the value itself, with the ``handle`` under which every rank
    keeps its own."""

    handle: int = -1


@dataclasses.dataclass(frozen=True)
class _Ref:
    handle: int


@dataclasses.dataclass
class ReplayStats:
    """Rank 0's sends (or a follower's receives): op messages and decisions,
    each with the seconds spent in their broadcasts (which include waiting
    for the other ranks to reach them)."""

    ops: int = 0
    op_seconds: float = 0.0
    decisions: int = 0
    decision_seconds: float = 0.0


class Replay:
    """The channel of one engine over ``mesh`` (a ``parallel.Mesh``); a
    channel without a group when the mesh has one device or is None."""

    def __init__(self, mesh=None):
        many = mesh is not None and mesh.device_mesh is not None
        self.rank = dist.get_rank() if many else 0
        # Every rank creates the group, in the same order as its other groups.
        self.group = (dist.new_group(backend="gloo",
                                     timeout=datetime.timedelta(seconds=TIMEOUT_S))
                      if many else None)
        self._ops: dict[str, Callable] = {_NOOP: lambda own=None: None}
        self._order = threading.Lock()  # rank 0: one op at a time, in order
        self._table: dict[int, Any] = {}  # followers: handle -> this rank's value
        self._next_handle = 0
        self._frees: list[int] = []  # rank 0: handles dropped since the last message
        self._frees_lock = threading.Lock()
        self._last_send = time.monotonic()
        self._closed = threading.Event()
        self.stats = ReplayStats()
        self.kept_at_stop = 0  # a follower: the values still kept when rank 0 closed
        self._keepalive = None

    def open(self) -> None:
        """Rank 0, once the engine is built on every rank (its last
        collective outside an op, ``share``, done): start the keep-alive."""
        if self.group is not None and self.leader and self._keepalive is None:
            self._last_send = time.monotonic()
            self._keepalive = threading.Thread(target=self._keep_alive, daemon=True,
                                               name="replay-keepalive")
            self._keepalive.start()

    @property
    def leader(self) -> bool:
        """True on rank 0 (and on a channel without a group)."""
        return self.rank == 0

    def register(self, name: str, fn: Callable) -> None:
        """Name an op: ``fn(*args, own=None)``; ``own`` is what rank 0's
        caller passed and followers get None for (callables, which are not
        sent)."""
        self._ops[name] = fn

    # ------------------------------------------------------------------
    # Rank 0
    # ------------------------------------------------------------------
    def call(self, name: str, *args, own=None):
        """Run op ``name`` on every rank (rank 0 only; in place inside an op
        or without a group) and return rank 0's result."""
        fn = self._ops[name]
        if self.group is None or current() is self:
            return fn(*args, own=own)
        if not self.leader:
            raise RuntimeError(f"replay op {name!r}: only rank 0 starts device operations")
        if self._closed.is_set():
            raise RuntimeError(f"replay op {name!r}: the channel is closed")
        with self._order:
            self._send_op(name, args)
            return self._run(fn, args, own)

    def decide(self, fn: Optional[Callable]) -> bool:
        """Rank 0's ``bool(fn())`` on every rank: inside an op, rank 0 calls
        it and broadcasts the answer; a follower returns the answer without
        calling its own."""
        if self.group is None or current() is not self:
            return bool(fn())
        t = time.perf_counter()
        value = torch.zeros(1, dtype=torch.uint8)
        if self.leader:
            value[0] = bool(fn())
        dist.broadcast(value, src=0, group=self.group)
        self.stats.decisions += 1
        self.stats.decision_seconds += time.perf_counter() - t
        return bool(value[0])

    def decider(self, fn: Optional[Callable]) -> Callable:
        """A callable that gives ``decide(fn)`` where it is called: rank 0's
        abort callback on every rank (a follower passes any placeholder)."""
        if self.group is None:
            return fn
        return lambda: self.decide(fn)

    def share(self, value):
        """Rank 0's ``value`` on every rank (outside an op: every rank calls
        it at the same point, e.g. while building the engine)."""
        if self.group is None:
            return value
        box = [value if self.leader else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def keep(self, value):
        """A device value that outlives this op, under the next handle.
        Returns rank 0's ``Held`` (or, on a follower, its own value, also
        kept in its table); the value itself without a group."""
        if self.group is None:
            return value
        if current() is not self:
            raise RuntimeError("keep(): only inside an op, where every rank keeps alike")
        handle = self._next_handle
        self._next_handle += 1
        held = Held(value)
        held.handle = handle
        if self.leader:
            weakref.finalize(held, self._free, handle)
        else:
            self._table[handle] = held
        return held

    def flush(self) -> None:
        """Free the dropped handles on the followers now (rank 0; no-op when
        none is pending or inside an op, whose message will carry them)."""
        if self.group is None or not self.leader or current() is self:
            return
        with self._frees_lock:
            pending = bool(self._frees)
        if pending:
            self.call(_NOOP)

    def close(self) -> None:
        """Rank 0: send ``stop``; every follower leaves ``follow()``."""
        if self.group is None or not self.leader or self._closed.is_set():
            return
        with self._order:
            self._send_op(_STOP, ())
            self._closed.set()
        if self._keepalive is not None:
            self._keepalive.join(timeout=5)

    def _free(self, handle: int) -> None:
        with self._frees_lock:
            self._frees.append(handle)

    def _send_op(self, name: str, args: tuple) -> None:
        with self._frees_lock:
            frees, self._frees = self._frees, []
        t = time.perf_counter()
        msg = [(name, _encode(args), frees)]
        dist.broadcast_object_list(msg, src=0, group=self.group)
        self._last_send = time.monotonic()
        self.stats.ops += 1
        self.stats.op_seconds += time.perf_counter() - t

    def _run(self, fn: Callable, args: tuple, own):
        _current.channel = self
        try:
            return fn(*args, own=own)
        finally:
            _current.channel = None

    def _keep_alive(self) -> None:
        period = TIMEOUT_S / 4
        while not self._closed.wait(period / 4):
            if time.monotonic() - self._last_send < period:
                continue
            if self._order.acquire(blocking=False):
                try:
                    if not self._closed.is_set():
                        self._send_op(_NOOP, ())
                except Exception:  # noqa: BLE001 — the next op meets the same failure
                    log.exception("replay keep-alive failed")
                    return
                finally:
                    self._order.release()

    # ------------------------------------------------------------------
    # Followers
    # ------------------------------------------------------------------
    def follow(self) -> None:
        """Ranks above 0: receive and run rank 0's ops in order until it
        closes the channel. Raises when the channel fails."""
        if self.group is None or self.leader:
            raise RuntimeError("follow(): only a rank above 0 of a mesh follows")
        while True:
            t = time.perf_counter()
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self.group)
            name, args, frees = msg[0]
            self.stats.ops += 1
            self.stats.op_seconds += time.perf_counter() - t
            for handle in frees:
                self._table.pop(handle, None)
            if name == _STOP:
                self.kept_at_stop = len(self._table)
                self._table.clear()
                return
            if name == _NOOP:
                continue
            try:
                self._run(self._ops[name], _decode(args, self._table), None)
            except Exception:  # noqa: BLE001 — rank 0 met the same, or the channel says so
                log.exception("replay op %r raised on rank %d", name, self.rank)


def channel_for(model, mesh, replay: Optional[Replay], owner: str) -> Replay:
    """The channel that a batcher or a gang over ``model`` runs its device
    work on: ``replay``, or one that runs each op in place. Raises where
    ``mesh`` is not the one ``model`` is sharded on, or where ``model``
    spans several processes and the channel has no group."""
    own = getattr(model, "mesh", None)
    if mesh is not None and mesh is not own:
        raise ValueError(f"{owner}(mesh=...): the mesh must be the one the model is sharded "
                         "on (parallel/mesh.shard_params)")
    replay = replay or Replay()
    if own is not None and own.device_mesh is not None and replay.group is None:
        raise ValueError(f"{owner}: a model sharded over several processes needs its engine's "
                         "replay channel (parallel/replay.py)")
    return replay


def _encode(x):
    """Op arguments for the wire: a ``Held`` becomes its handle; tensors are
    refused (each rank holds its own device values)."""
    if isinstance(x, Held):
        return _Ref(x.handle)
    if isinstance(x, torch.Tensor):
        raise TypeError("replay: a tensor is not an op argument (keep() it, or send numpy)")
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    return x


def _decode(x, table: dict):
    if isinstance(x, _Ref):
        return table[x.handle]
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v, table) for v in x)
    if isinstance(x, dict):
        return {k: _decode(v, table) for k, v in x.items()}
    return x

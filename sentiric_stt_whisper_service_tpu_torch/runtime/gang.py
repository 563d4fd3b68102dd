"""Gang batching of beam-search windows across concurrent requests, held
against the JAX package's ``runtime/gang.py``.

Beam decodes cannot share the continuous batcher's slots (per-beam ancestry
and lockstep candidate reordering), but they batch along the window axis:
``decode_window_beam`` runs [B] windows at once, and a step reads the same
weights whatever its B. Concurrent beam windows of one shape class
(:class:`GangKey`) arriving within ``window_ms`` are coalesced into one
batched call, padded to a power-of-two bucket with copies of member 0, so
that the decode's graph classes stay {1, 2, 4, ..., max_gang}. Requests
keep their own threads and block on a Future; every member's future is
resolved, also when the batched decode raises.

On the card the decode replays through a ``DecodeGraphs`` that the gang
owns (its own memory pool, one class per B bucket), captured under the
device lock held exclusively; the worker holds the lock shared while it
decodes.

Over a mesh (``mesh``, the mesh of a model sharded by
``parallel/mesh.shard_params``) one gang decode is one op of the engine's
replay channel (``replay``, ``parallel/replay.py``), carrying the members'
cross-K/V handles and prompt rows, the bucket and the ``GangKey``; rank 0
forms the gangs and decides the aborts, the other ranks run no worker and
replay the decodes. Under a tp group the decode runs eagerly.

While a device trace records (``tracing``), the worker's spans have the
role ``worker``: ``gang.idle`` (the wait for a first item) and
``gang.coalesce`` (the wait for its gang) are wait spans, ``gang.decode``
the decode, with its ``members`` (real windows), ``bucket``, ``max_len``
(the ``GangKey``'s) and the ``requests`` it serves (the ids of the
``request`` spans that submitted them). Each decode that ends is also a
counter ``gang.decode`` (``members``, ``bucket``), also one whose span
began before the trace.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..models.beam import decode_window_beam
from ..models.graphs import DecodeGraphs, DeviceLock, to_device
from ..models.sampling import DecodeResult
from ..parallel.replay import Replay, channel_for


@dataclass(frozen=True)
class GangKey:
    """Shape and semantics class: members of one gang agree on every
    argument of ``decode_window_beam`` but the window's cross K/V and
    prompt row."""

    sample_begin: int
    sot_index: int
    beam_size: int
    max_len: int
    prefill_len: int
    xa_f: int  # cross-KV context width (audio_ctx bucket)
    use_timestamps: bool


@dataclass
class _Item:
    key: GangKey
    xa_kv: dict  # [L, 1, ...] leaves for one window
    tokens_row: np.ndarray  # [ctx] int
    future: Future = field(default_factory=Future)
    # Polled between decode chunks: an aborted member resolves None at once,
    # and the batched decode stops once every member has aborted.
    should_abort: Optional[callable] = None
    request: int = 0  # the submitting request's id while the tracer is on


class BeamGang:
    """Coalesce same-shape beam decodes into one batched call.

    One worker thread owns the decode calls. ``submit`` returns a Future
    resolving to a single-window DecodeResult (batch dim of 1 kept, the
    contract of ``decode_window_beam`` at B = 1) on the gang's device."""

    def __init__(
        self,
        cfg,
        params,
        ids,
        suppress_mask: torch.Tensor,
        window_ms: int = 30,
        max_gang: int = 8,
        self_dtype=None,
        others_hint=None,
        mesh=None,
        device_lock: Optional[DeviceLock] = None,
        replay: Optional[Replay] = None,
    ):
        replay = channel_for(params, mesh, replay, "BeamGang")
        self.cfg, self.params, self.ids = cfg, params, ids
        self.suppress_mask = suppress_mask
        self.device = suppress_mask.device
        self.window_s = max(0.0, window_ms / 1000.0)
        self.max_gang = max(1, max_gang)
        self.self_dtype = self_dtype
        # Callable → requests inside the engine's beam path: when nobody
        # beyond the collected gang is in flight, the timed wait is skipped.
        self.others_hint = others_hint
        self._lock = device_lock or DeviceLock()
        self.graphs = DecodeGraphs(lock=self._lock)
        self._decoding = threading.Lock()  # the worker's and warmup()'s use of self.graphs
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._pending: list[_Item] = []  # items deferred by a key mismatch
        self._stop = threading.Event()
        self._replay = replay
        replay.register("gang", self._decode_op)
        self._worker = None
        if replay.leader:  # the other ranks of a mesh replay rank 0's decodes
            self._worker = threading.Thread(target=self._run, name="beam-gang", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, xa_kv: dict, tokens_row: np.ndarray, key: GangKey,
               should_abort=None) -> Future:
        item = _Item(key=key, xa_kv=xa_kv, tokens_row=np.asarray(tokens_row),
                     should_abort=should_abort)
        if tracing.on:
            item.request = tracing.request_id()
        self._q.put(item)
        return item.future

    def shutdown(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        # Callers blocked in fut.result() must never hang on shutdown.
        self._drain_unresolved(RuntimeError("beam gang shut down"))

    def warmup(self, xa_kv: dict, tokens_row: np.ndarray, key: GangKey) -> None:
        """Capture the decode's class at every batch bucket for ``key``, each
        decode cut at its first chunk."""
        for b in sorted({self.batch_bucket(n) for n in range(1, self.max_gang + 1)}):
            polls = iter((False,))
            item = _Item(key, xa_kv, np.asarray(tokens_row),
                         should_abort=lambda polls=polls: next(polls, True))
            self._decode([item] * b)

    def _drain_unresolved(self, exc: Exception) -> None:
        leftovers = list(self._pending)
        self._pending = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                leftovers.append(it)
        for it in leftovers:
            if not it.future.done():
                it.future.set_exception(exc)

    # ------------------------------------------------------------------
    def _collect_gang(self, first: _Item) -> list[_Item]:
        """Drain same-key items for up to window_ms; defer mismatches."""
        gang = [first]
        keep = []  # same-key items deferred from earlier collections join first
        for it in self._pending:
            if it.key == first.key and len(gang) < self.max_gang:
                gang.append(it)
            else:
                keep.append(it)
        self._pending = keep
        while len(gang) < self.max_gang:  # what is queued already
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:  # shutdown sentinel
                self._q.put(None)
                return gang
            if item.key == first.key:
                gang.append(item)
            else:
                self._pending.append(item)
        # A timed wait only when another beam request could still join.
        if self.others_hint is not None and self.others_hint() <= len(gang):
            return gang
        deadline = time.monotonic() + self.window_s
        while len(gang) < self.max_gang:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)
                break
            if item.key == first.key:
                gang.append(item)
            else:
                self._pending.append(item)
        return gang

    def _next_item(self) -> Optional[_Item]:
        if self._pending:
            return self._pending.pop(0)
        return self._q.get()

    def _run(self) -> None:
        try:
            with tracing.worker_role():
                while not self._stop.is_set():
                    with tracing.begin("gang.idle", tracing.WAIT) if tracing.on else tracing.OFF:
                        item = self._next_item()
                    if item is None:
                        break
                    with (tracing.begin("gang.coalesce", tracing.WAIT) if tracing.on
                          else tracing.OFF):
                        gang = self._collect_gang(item)
                    self._resolve(gang)
        finally:
            # Worker exit (sentinel, stop or a crash) orphans nothing.
            self._drain_unresolved(RuntimeError("beam gang worker exited"))

    def _resolve(self, gang: list[_Item]) -> None:
        try:
            try:
                with (tracing.begin("gang.decode") if tracing.on else tracing.OFF) as sp:
                    if sp is not None:
                        sp.attrs.update(members=len(gang), bucket=self.batch_bucket(len(gang)),
                                        max_len=gang[0].key.max_len,
                                        requests=tuple(it.request for it in gang))
                    res = self._decode(gang)
            finally:
                if tracing.on:
                    tracing.count("gang.decode", members=len(gang),
                                  bucket=self.batch_bucket(len(gang)))
            for i, it in enumerate(gang):
                if it.future.done():  # aborted mid-decode: already None
                    continue
                if res is None:  # every member aborted; the decode stopped
                    it.future.set_result(None)
                    continue
                it.future.set_result(DecodeResult(*(x[i : i + 1] for x in res)))
        except Exception as e:  # noqa: BLE001 — resolve EVERY future
            for it in gang:
                if not it.future.done():
                    it.future.set_exception(e)

    def batch_bucket(self, n: int) -> int:
        """The batch-shape bucket: the next power of two ≥ n (below
        max_gang), so that the decode's classes are {1, 2, 4, ...}."""
        b = 1
        while b < min(n, self.max_gang):
            b *= 2
        return b

    def _decode(self, gang: list[_Item]) -> Optional[DecodeResult]:
        gang_abort = None
        if any(it.should_abort is not None for it in gang):
            # Aborted members resolve None between chunks; the decode stops
            # only when every member has aborted.
            def gang_abort():
                all_gone = True
                for it in gang:
                    if it.future.done():
                        continue
                    if it.should_abort is not None and it.should_abort():
                        it.future.set_result(None)
                    else:
                        all_gone = False
                return all_gone

        return self._replay.call(
            "gang", gang[0].key, [(it.xa_kv, it.tokens_row) for it in gang],
            self.batch_bucket(len(gang)), gang_abort is not None, own=gang_abort)

    def _decode_op(self, key: GangKey, members: list, bucket: int, abortable: bool,
                   own=None) -> Optional[DecodeResult]:
        """One gang's decode on every rank: ``members`` (cross K/V, prompt
        row) padded to ``bucket`` with copies of member 0 (the windows'
        beams are independent, and _resolve reads the first len(gang) rows
        only); rank 0's abort poll (``own``) decides for every rank."""
        items = list(members) + [members[0]] * (bucket - len(members))
        abort = self._replay.decider(own) if abortable else None
        with self._decoding, self._lock.shared(), torch.inference_mode():
            if len(items) == 1:
                xa_kv = members[0][0]
            else:
                xa_kv = {n: torch.cat([xa[n] for xa, _ in items], dim=1) for n in members[0][0]}
            tinit = to_device(np.stack([row for _, row in items]).astype(np.int64), self.device)
            return decode_window_beam(
                self.cfg, self.params, xa_kv, tinit, key.sample_begin,
                key.sot_index, self.ids, self.suppress_mask, beam_size=key.beam_size,
                max_len=key.max_len, use_timestamps=key.use_timestamps,
                prefill_len=key.prefill_len, self_dtype=self.self_dtype,
                should_abort=abort, graphs=self.graphs)

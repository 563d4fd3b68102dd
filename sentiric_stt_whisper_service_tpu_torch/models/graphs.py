"""CUDA graphs of the decode steps: the port's counterpart of the JAX
package's ``jax.jit`` over its window loops (``models/sampling.py``
``_decode_window_impl`` / ``_decode_chunk_impl``, ``models/beam.py``
``_decode_window_beam_impl`` / ``_beam_chunk_impl``).

A window's loop is a :class:`StepLoop`: its state and its per-request
inputs (cross slab, suppression row, temperature) in tensors, and one step
function that reads them and updates the state in place, with the position
and the loop's flags on the device. On the CPU, or on CUDA when the caller
asks for eager decoding, the loop calls the step over the caller's own
tensors. Otherwise :class:`DecodeGraphs`, which the caller creates and
keeps, holds one loop per shape class with static copies of the inputs,
and one captured graph of the step per read bound (the counterpart of the
JAX package's ``lax.switch`` over read buckets): a request copies its
inputs into the class's buffers, its prefill writes the state there, and
the host replays.

* **Capture.** An eager warm-up of every bound on a side stream first
  builds the kernel library and runs the kernels' shared-memory opt-ins and
  cuBLAS's set-up, none of which a capture may do. Then each bound's step
  is captured into one memory pool shared by every graph of the cache:
  their replays are serial on one stream and every graph writes its results
  into the static buffers, so the temporaries that one graph leaves behind
  are dead before another runs.
* **No fallback.** A capture or a replay that fails raises; nothing carries
  on eagerly.
* **Launch counts.** ``kernels.LAUNCHES`` counts on the host, where a replay
  calls no wrapper: each graph keeps the counts its capture added (taken
  back out, since a capture launches nothing) and adds them at every replay.
  Beside them each graph keeps the kernel calls its capture made, keyed by
  (library function, sizes) (``kernels.collecting``), and a replay while
  the tracer is on (``tracing``) adds them to its session.
* **Spans.** While the tracer is on, a capture is a ``capture`` span, the
  wait inside :func:`to_host` a ``to_host`` wait span, and each acquisition
  of a named :class:`DeviceLock` a wait span (``<name>.shared``,
  ``<name>.exclusive``).
* **Random draws.** A sampled step with the caller's generator draws, in
  the graph, from a generator of the class registered with its graphs: the
  caller's state is copied into it before the replays and back after, so
  the caller's generator advances as an eager decode would advance it.
* **Other threads.** A capture (``torch.cuda.graph``'s "global" mode)
  fails, or takes in foreign work, if another thread launches, allocates,
  copies or synchronises on the card meanwhile. Where several threads share
  the card (the engine's requests, the continuous batcher's and the beam
  gang's workers), each holds a :class:`DeviceLock` shared around its
  device work, and a capture holds it exclusively. Copies between the host
  and the card on those paths go through :func:`to_host` and
  :func:`to_device`: a blocking copy issued while the stream is busy holds
  up every other thread's launches until the stream drains (measured by
  ``chip_threads.py``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Optional

import torch

from .. import kernels, tracing
from ..parallel.replay import current as replay_channel


class DeviceLock:
    """A reader–writer lock over the card: device work holds it shared, a
    CUDA graph capture exclusively. Both are reentrant per thread, and a
    thread that holds it shared may ask for it exclusively (it gives its
    shared hold up while it waits, and takes it back after). A waiting
    capture goes before new shared holders. A thread never waits on another
    thread while it holds the lock shared. With a ``name``, each acquisition
    that is not nested in a hold of the thread is a wait span while the
    tracer is on."""

    def __init__(self, name: Optional[str] = None):
        self._span_shared = f"{name}.shared" if name else None
        self._span_exclusive = f"{name}.exclusive" if name else None
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: Optional[int] = None
        self._writers_waiting = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        depth = getattr(self._local, "depth", 0)
        if depth or self._writer == me:  # nested in a hold of this thread
            self._local.depth = depth + 1
            try:
                yield
            finally:
                self._local.depth -= 1
            return
        with (tracing.begin(self._span_shared, tracing.WAIT) if tracing.on and self._span_shared
              else tracing.OFF), self._cond:
            while self._writer is not None or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        self._local.depth = 1
        try:
            yield
        finally:
            self._local.depth = 0
            with self._cond:
                self._readers -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._writer == me:  # nested in this thread's exclusive hold
            yield
            return
        depth = getattr(self._local, "depth", 0)
        with (tracing.begin(self._span_exclusive, tracing.WAIT)
              if tracing.on and self._span_exclusive else tracing.OFF), self._cond:
            if depth:  # give this thread's shared hold up while waiting
                self._readers -= 1
            self._writers_waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = me
        self._local.depth = 0
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()
                if depth:  # take the shared hold back; waiting writers go first
                    while self._writer is not None or self._writers_waiting:
                        self._cond.wait()
                    self._readers += 1
            self._local.depth = depth


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host. On the card the copy is queued into pinned
    memory and the thread then waits on an event, which leaves the other
    threads' launches free meanwhile (``.cpu()`` waits inside the copy and
    stalls them)."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    with tracing.begin("to_host", tracing.WAIT) if tracing.on else tracing.OFF:
        done.synchronize()
    return host


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``: on the card through pinned
    memory with a non-blocking copy (a copy from pageable memory waits for
    the stream to drain first); on the CPU as it is."""
    t = torch.as_tensor(a)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# Held shared around every CUDA graph launch and capture in the process, and
# exclusively by a device trace's start and stop (``serving/device_trace``):
# CUPTI's activity calls deadlock beside a graph launch in another thread
# (``chip_profile.py --cupti-probe``). A launch holds it for its host call
# only, so the trace waits for at most one launch per thread.
GRAPH_LAUNCHES = DeviceLock()


def read_bound(pos: int, bounds) -> int:
    """The read bound of a step at ``pos``: the first of the ascending
    ``bounds`` above it, else the last (the whole slab)."""
    return next((b for b in bounds if pos < b), bounds[-1])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_copy(dst, src) -> None:
    if isinstance(dst, dict):
        for k, v in dst.items():
            _tree_copy(v, src[k])
    elif dst is not src:
        dst.copy_(src)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class StepLoop:
    """A window loop: ``state`` (a dataclass of tensors), ``inputs`` (a dict
    of tensors, nested one level for the cross slab) and ``step(state,
    bound)``. ``advance(bound)`` runs one step: eagerly, or by replaying the
    graph captured for ``bound``."""

    def __init__(self, state, inputs: dict, step: Callable,
                 generator: Optional[torch.Generator] = None):
        self.state, self.inputs, self.step = state, inputs, step
        self.generator = generator  # the class's own, registered with its graphs
        self.graphs: Optional[dict] = None  # bound -> (CUDAGraph, launches a replay)
        self.calls: dict = {}  # bound -> {kernels.work_key: calls a replay}
        self.capture_s = 0.0
        self.static_bytes = 0
        self.pool_bytes = 0

    @property
    def graphed(self) -> bool:
        return self.graphs is not None

    def load(self, inputs: dict) -> None:
        """Copy a request's inputs into the static buffers (no copy when the
        loop runs over the caller's own tensors)."""
        _tree_copy(self.inputs, inputs)

    def advance(self, bound: int) -> None:
        if self.graphs is None:
            self.step(self.state, bound)
            return
        graph, launches = self.graphs[bound]
        with GRAPH_LAUNCHES.shared():
            graph.replay()
        for name, n in launches.items():
            kernels.LAUNCHES[name] += n
        if tracing.on:
            tracing.add_calls(self.calls.get(bound))

    @contextlib.contextmanager
    def drawing_from(self, generator: Optional[torch.Generator]):
        """Replays draw from ``generator``'s state, which advances as an
        eager decode's would (no-op for an eager loop or no generator)."""
        if self.generator is None or generator is None:
            yield
            return
        self.generator.set_state(generator.get_state())
        try:
            yield
        finally:
            generator.set_state(self.generator.get_state())


def _capture(loop: StepLoop, bounds, pool) -> int:
    """Warm up and capture every bound's step; returns the bytes the
    captures added to the device memory reserved (the pool's growth)."""
    with (tracing.begin("capture") if tracing.on else tracing.OFF) as sp:
        if sp is not None:
            sp.attrs["bounds"] = len(bounds)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for bound in bounds:
                loop.step(loop.state, bound)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as each capture does first: the warm-up's blocks
        reserved = torch.cuda.memory_reserved()
        graphs, calls = {}, {}
        for bound in bounds:
            graph = torch.cuda.CUDAGraph()
            if loop.generator is not None:
                graph.register_generator_state(loop.generator)
            before = dict(kernels.LAUNCHES)
            try:
                with (GRAPH_LAUNCHES.shared(), kernels.collecting() as keyed,
                      torch.cuda.graph(graph, pool=pool)):
                    loop.step(loop.state, bound)
            finally:
                added = {k: kernels.LAUNCHES[k] - n for k, n in before.items()}
                kernels.LAUNCHES.update(before)
            graphs[bound] = (graph, {k: n for k, n in added.items() if n})
            calls[bound] = dict(collections.Counter(keyed))
        loop.graphs, loop.calls = graphs, calls
        return torch.cuda.memory_reserved() - reserved


class DecodeGraphs:
    """The caller's cache of captured decode steps, one :class:`StepLoop` per
    shape class (config and weights, rows, beams, cache length, read bounds,
    slab form, self dtype, greedy or sampled, rules), all graphs in one
    memory pool. Keep one for the life of a model: a class is captured once,
    at its first request."""

    def __init__(self, lock: Optional[DeviceLock] = None):
        self._loops: dict = {}
        self._pool = None
        self._lock = lock  # held exclusively while a class captures

    def loop(self, key, make: Callable, inputs: dict, bounds, device: torch.device,
             own_generator: bool) -> StepLoop:
        """The class under ``key`` with ``inputs`` loaded, made and captured
        first if it is new: ``make(inputs, generator)`` returns (state,
        step) over the tensors it is given."""
        loop = self._loops.get(key)
        if loop is None:
            with self._lock.exclusive() if self._lock else contextlib.nullcontext():
                loop = self._new_loop(key, make, inputs, bounds, device, own_generator)
        else:
            loop.load(inputs)
        return loop

    def _new_loop(self, key, make, inputs, bounds, device, own_generator) -> StepLoop:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = _tree_map(torch.empty_like, inputs)
        static_bytes = _tree_bytes(static)
        generator = torch.Generator(device=device) if own_generator else None
        state, step = make(static, generator)
        loop = StepLoop(state, static, step, generator)
        loop.load(inputs)  # before the warm-up, which reads them
        loop.pool_bytes = _capture(loop, bounds, self._pool)
        loop.capture_s = time.perf_counter() - t0
        loop.static_bytes = static_bytes + _tree_bytes(vars(state))
        self._loops[key] = loop
        return loop

    def stats(self) -> list[dict]:
        """Per class: its graphs, capture seconds (eager warm-up included),
        its static buffers' bytes and the bytes its captures added to the
        shared pool."""
        return [dict(key=key, graphs=len(loop.graphs), capture_s=loop.capture_s,
                     static_bytes=loop.static_bytes, pool_bytes=loop.pool_bytes)
                for key, loop in self._loops.items()]


def graphable(model) -> bool:
    """False for a tensor-parallel shard (``parallel/mesh.shard_params``):
    its all-reduces over gloo run on the host, where a CUDA graph cannot
    capture them, so its steps run eagerly."""
    mesh = getattr(model, "mesh", None)
    return mesh is None or mesh.group("tp") is None


def window_loop(device: torch.device, graph: bool, graphs: Optional[DecodeGraphs], key,
                make: Callable, inputs: dict, bounds, generator) -> StepLoop:
    """The loop that decodes one window on ``device``: eager over the
    caller's tensors on the CPU or when ``graph`` is false, else the class of
    ``key`` in ``graphs`` (a cache made for this call when none is given)."""
    if device.type != "cuda" or not graph:
        state, step = make(inputs, generator)
        return StepLoop(state, inputs, step)
    graphs = graphs if graphs is not None else DecodeGraphs()
    return graphs.loop(key, make, inputs, bounds, device, own_generator=generator is not None)


def run_window(loop: StepLoop, start: int, hard_stop: int, bounds, finished: Callable,
               should_abort=None, chunk: int = 32) -> bool:
    """The host side of a window's loop, from position ``start`` up to
    ``hard_stop``: ``should_abort`` is polled before each chunk of ``chunk``
    steps (the JAX package's abortable path), and ``finished()``, which reads
    the device, after it. The host keeps the position itself: each step
    advances it by one on the device too, until the step's own flag stops
    it, so a replay past the end changes nothing that the result reads.
    An eager loop checks ``finished()`` after every step as well. Returns
    False if aborted.

    Inside an op of a mesh's replay channel (``parallel/replay.py``) the
    window's stop is rank 0's: ``finished()`` answers there and every rank
    takes its answer, so that every rank runs the same steps (the caller
    routes ``should_abort`` the same way)."""
    channel = replay_channel()
    if channel is not None:
        own_finished = finished

        def finished() -> bool:
            return channel.decide(own_finished)

    pos = start
    while pos < hard_stop:
        if should_abort is not None and should_abort():
            return False
        until = min(pos + max(1, chunk), hard_stop)
        while pos < until:
            loop.advance(read_bound(pos, bounds))
            pos += 1
            if not loop.graphed and finished():
                break
        if finished():
            break
    return True

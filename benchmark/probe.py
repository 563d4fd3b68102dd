"""What the benchmark reads of the kernels the card ran, at the shapes
their wrappers in ``ops/`` gave them: :class:`KernelTap` wraps
``kernels.call`` (every launch of the port's kernel library),
``models.graphs._capture`` (the calls a graph captured, per read bound) and
``StepLoop.advance`` (a replay runs its capture's calls again). Counting is
on only while ``active``. It is installed on the port's modules and removed
with :meth:`~KernelTap.remove`. What a model's engine served is its
family's tap (``families/<family>``).
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter


def kernel_work_key(name: str, args: tuple, signatures: dict) -> tuple:
    """(kernel library function, its size arguments): the sizes its wrapper
    in ``ops/`` read from the shapes of the tensors it was given (the
    ``c_int`` arguments of the library's C interface), and for K3 whether a
    causal position vector came with them."""
    sig = signatures.get(name, ())
    dims = tuple(a for a, t in zip(args, sig) if t is ctypes.c_int)
    if name in ("sstw_decode_attention_bf16", "sstw_decode_attention_i8"):
        dims += (args[3 if name.endswith("bf16") else 5] is not None,)
    return (name, dims)


class KernelTap:
    """Counts the port's kernel calls by (function, shapes) while active:
    eager launches as they are made, a graph replay as the calls its
    capture made."""

    def __init__(self):
        from sentiric_stt_whisper_service_tpu_torch import kernels
        from sentiric_stt_whisper_service_tpu_torch.models import graphs

        self.kernels, self.graphs = kernels, graphs
        self.active = False
        self.calls: Counter = Counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._captured: dict = {}  # id(StepLoop) -> {bound: [keys]}
        call, capture, advance = kernels.call, graphs._capture, graphs.StepLoop.advance
        self._orig = (call, capture, advance)
        tap = self

        def counted_call(name, *args):
            call(name, *args)
            key = kernel_work_key(name, args, kernels._SIGNATURES)
            sink = getattr(tap._local, "capture", None)
            if sink is not None and _capturing():
                sink.append(key)
            elif tap.active:
                with tap._lock:
                    tap.calls[key] += 1

        def counted_capture(loop, bounds, pool):
            tap._local.capture = sink = []
            try:
                out = capture(loop, bounds, pool)
            finally:
                tap._local.capture = None
            per_bound, at = {}, 0
            for bound in bounds:  # captured in bound order, each its own launches
                n = sum(loop.graphs[bound][1].values())
                per_bound[bound] = sink[at:at + n]
                at += n
            tap._captured[id(loop)] = per_bound
            return out

        def counted_advance(loop, bound):
            advance(loop, bound)
            if tap.active and loop.graphs is not None:
                keys = tap._captured.get(id(loop), {}).get(bound, ())
                with tap._lock:
                    tap.calls.update(keys)

        kernels.call = counted_call
        graphs._capture = counted_capture
        graphs.StepLoop.advance = counted_advance

    def remove(self) -> None:
        self.kernels.call, self.graphs._capture, self.graphs.StepLoop.advance = self._orig

    def take(self) -> Counter:
        with self._lock:
            out, self.calls = self.calls, Counter()
        return out


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()

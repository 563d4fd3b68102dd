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
CUPTI's activity state is the process's). The library is built at first
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
import os
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "device_trace.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-Wall")

_lock = threading.Lock()  # the library's build and load
_session = threading.Lock()  # one trace at a time: CUPTI's activity state is the process's
_lib = None


@dataclasses.dataclass
class TraceStats:
    """One trace: the seconds its stop waited for the graph launches in
    flight, the seconds it held new ones back (the stop itself: disable and
    flush), the seconds its write took, the events written, the kernel
    records kept, other records skipped, and records dropped (by CUPTI, or
    past the recorder's cap)."""

    wait_s: float = 0.0
    stop_s: float = 0.0
    write_s: float = 0.0
    events: int = 0
    kernels: int = 0
    other: int = 0
    dropped: int = 0


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
            _lib = loaded
    return _lib


def _check(loaded, what: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"device trace: {what}: CUPTI error {code} "
                           f"({loaded.sstw_trace_error(code).decode()})")


def record(seconds: float, path: str) -> TraceStats:
    """Trace the card for ``seconds`` and write the Chrome trace to
    ``path``; the device and every other thread run on meanwhile. The start
    and the stop hold ``models.graphs.GRAPH_LAUNCHES`` exclusively: each
    waits for the graph launches in flight (one host call each) and holds
    new ones back while it runs."""
    from ..models.graphs import GRAPH_LAUNCHES

    loaded = lib()
    with _session:
        with GRAPH_LAUNCHES.exclusive():
            _check(loaded, "start", loaded.sstw_trace_start())
        try:
            time.sleep(seconds)
        finally:
            t0 = time.perf_counter()
            with GRAPH_LAUNCHES.exclusive():
                t1 = time.perf_counter()
                _check(loaded, "stop", loaded.sstw_trace_stop())
                t2 = time.perf_counter()
        events = loaded.sstw_trace_write(str(path).encode())
        t3 = time.perf_counter()
        counts = (ctypes.c_longlong * 4)()
        loaded.sstw_trace_counts(counts)
    if events < 0:
        raise OSError(f"device trace: could not write {path}")
    return TraceStats(wait_s=t1 - t0, stop_s=t2 - t1, write_s=t3 - t2, events=int(events),
                      kernels=counts[0], other=counts[1], dropped=counts[2])

"""Build and load the hand-written Hopper kernels of ``csrc/``.

The kernels, each with the TPU kernel of the JAX package it replaces:

  * K1 ``log_mel`` (``csrc/mel.cu``, a 200-point FFT per frame and a sparse
    mel projection): ``ops/pallas_mel.py:74``;
  * K2 ``flash_attention`` (``csrc/flash_attention.cu``):
    ``ops/flash_attention.py:85``;
  * K3 ``decode_attention`` (``csrc/decode_attention.cu``, a cluster of
    eight blocks per (item, head) splitting F): ``ops/decode_attention.py:146``;
  * K4 ``decode_attention_i4`` (``csrc/decode_attention_i4.cu``, a cluster
    of eight blocks per (item, head) splitting F): ``ops/decode_attention.py:227``;
  * K5 ``beam_attention`` (``csrc/beam_attention.cu``, a cluster of four
    blocks per (item, head) splitting the positions):
    ``ops/beam_attention.py:214``;
  * K6 ``beam_cross_attention`` (``csrc/beam_cross_attention.cu``, a cluster
    of four blocks per (item, head) splitting d): ``ops/beam_attention.py:333``;
  * P1 ``flash_q8`` (``csrc/flash_q8.cu``, a quantizing pre-pass, a cluster
    of eight blocks per (batch, head), then two passes of int8 ``wgmma``
    QKᵀ per 128-row query tile fed by a ``cp.async`` ring): the JAX
    package's probe ``tools/bench_flash_int8.py:105``;
  * W8 ``dense_w8`` (``csrc/dense_w8.cu``, the weight-only int8 product at
    small M, split K over a cluster of up to eight blocks): no TPU kernel,
    the JAX package leaves it to XLA's operand fusion
    (``models/whisper.py:260``, ``:287``).

K3, K5 and K6 share the constants and slab forms of
``csrc/slab_attention.cuh``; K3, K4 and K5 the split-softmax pieces of
``csrc/split_softmax.cuh`` (cp.async, exp2, the cluster merge).

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
for ``sm_90a``; one more links the objects into one shared library with a
plain C interface, loaded through ``ctypes``. The library
goes to ``_build/`` beside this package, named by a hash of the sources and
flags, so a changed source builds anew and an unchanged one is reused. The
build happens at first use (never at import: the CPU tests import every
module on machines with no ``nvcc``), from this checkout's sources only.

Every exported function launches on the stream it is given and returns the
``cudaError_t`` of the launch; :func:`call` raises on anything but 0.
``LAUNCHES`` counts launches per kernel: each wrapper in ``ops/`` adds one
right after its launch and nowhere else, so a run can show that the main
path went through the kernels. While the tracer is on (``tracing``, during
a device trace) :func:`call` also counts each call by (library function,
size arguments) (:func:`work_key`) into the tracer's session; a CUDA graph's
capture keeps the keyed calls it made (:func:`collecting`) whether the
tracer is on or not, and each replay adds them (``models/graphs.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "log_mel": 0,  # K1, ops/fused_mel.py
    "flash_attention": 0,  # K2, ops/flash_attention.py
    "decode_attention": 0,  # K3, ops/decode_attention.py (bf16 and int8 forms)
    "decode_attention_i4": 0,  # K4, ops/decode_attention.py
    "beam_attention": 0,  # K5, ops/beam_attention.py (bf16 and int8 forms)
    "beam_cross_attention": 0,  # K6, ops/beam_attention.py (bf16, int8 and int4 forms)
    "flash_q8": 0,  # P1, ops/flash_q8.py (qk8 and full8 modes)
    "dense_w8": 0,  # W8, ops/dense_w8.py (dense and logits forms)
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sstw_log_mel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sstw_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _P],
    "sstw_decode_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sstw_decode_attention_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sstw_decode_attention_i4": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sstw_beam_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sstw_beam_attention_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sstw_beam_cross_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "sstw_beam_cross_attention_i8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "sstw_beam_cross_attention_i4": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "sstw_flash_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sstw_dense_w8": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "sstw_logits_w8": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_sink = threading.local()  # .calls: the keyed calls a capture on this thread collects
_collecting = 0  # captures collecting keyed calls in the process
_collecting_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsstw_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling, compiler messages);
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    out = library_path()
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = "".join(p.communicate()[0] for p in procs)
    try:
        failed = [p.args[-1] for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            failed = ["(link)"] if link.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            loaded = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.sstw_error_string.argtypes = [ctypes.c_int]
            loaded.sstw_error_string.restype = ctypes.c_char_p
            _lib = loaded
    return _lib


def call(name: str, *args) -> None:
    """Launch ``name`` from the library; raise if the launch is refused."""
    loaded = lib()
    err = getattr(loaded, name)(*args)
    if err != 0:
        msg = loaded.sstw_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    if _collecting or tracing.on:
        calls = getattr(_sink, "calls", None)
        if calls is not None:
            calls.append(work_key(name, args))
        elif tracing.on:
            tracing.add_call(work_key(name, args))


def work_key(name: str, args: tuple) -> tuple:
    """(library function, its size arguments): the sizes its wrapper in
    ``ops/`` read from the shapes of the tensors it was given (the ``c_int``
    arguments of the C interface), and for K3 whether a causal position
    vector came with them."""
    dims = tuple(a for a, t in zip(args, _SIGNATURES.get(name, ())) if t is ctypes.c_int)
    if name in ("sstw_decode_attention_bf16", "sstw_decode_attention_i8"):
        dims += (args[3 if name.endswith("bf16") else 5] is not None,)
    return (name, dims)


class collecting:
    """Inside it, the calling thread's calls are collected into ``calls``
    (their :func:`work_key`) and counted nowhere else: a graph capture,
    which launches nothing."""

    def __enter__(self) -> list:
        global _collecting
        with _collecting_lock:
            _collecting += 1
        _sink.calls = []
        return _sink.calls

    def __exit__(self, *exc):
        global _collecting
        _sink.calls = None
        with _collecting_lock:
            _collecting -= 1
        return False


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, *tensors, dtypes=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and, with ``dtypes``, of the matching dtype)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected {dev} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, expected {dtypes[i]}")

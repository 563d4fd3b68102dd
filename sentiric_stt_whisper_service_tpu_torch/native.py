"""Host-side native code: the WAV parser of the repository's C++ library
(``native/sstw_native.cpp``, shared with the JAX package), and the
streaming PCM16 ingest buffer in its pure-Python form.

``get_lib`` builds the library at first use with ``g++`` into this
package's ``_build/`` (named by a hash of the source and flags, so a
changed source builds anew; the JAX package's ``make -C native`` output
in ``native/`` is not touched) and binds the same C entry points as the
JAX package's ``native.py``: ``sstw_parse_wav`` and ``sstw_free``. Where
there is no compiler or no source, or ``SSTW_NO_NATIVE_BUILD=1`` is set
and nothing is built yet, it returns None and ``parse_wav_native`` returns
None too: ``audio/wav.parse_wav_robust`` then keeps its Python parser, as
the JAX package does.

``StreamBuffer`` is the JAX package's buffer in its numpy form (the JAX
package backs it with the C++ ring buffer when that is built). It lives on
the host: a streaming session reads it whole on every tick.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[1] / "native" / "sstw_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsstw_native-{digest[:16]}.so"


def _build(path: Path) -> bool:
    """``g++`` the source into ``path`` (through a temporary file renamed
    into place, so that processes building at once never load half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            log.warning("native build failed: %s", proc.stderr[-2000:])
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info("native build unavailable: %s", e)
        return False
    finally:
        Path(tmp).unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.is_file():
            log.info("native source %s not found; using the Python parser", SOURCE)
            return None
        path = _lib_path()
        if not path.exists():
            if os.environ.get("SSTW_NO_NATIVE_BUILD") == "1" or not _build(path):
                log.info("native library unavailable; using the Python parser")
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("failed to load the native library: %s", e)
            return None
        lib.sstw_parse_wav.restype = ctypes.c_int
        lib.sstw_parse_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sstw_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_wav_native(data: bytes):
    """Native WAV parse → (pcm int16, rate, channels), or None where the
    library is unavailable or the parse fails (the caller then takes the
    Python parser)."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_size_t()
    rate = ctypes.c_int32()
    ch = ctypes.c_int32()
    rc = lib.sstw_parse_wav(data, len(data), ctypes.byref(out), ctypes.byref(n),
                            ctypes.byref(rate), ctypes.byref(ch))
    if rc != 0:
        return None
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.sstw_free(out)
    return pcm, rate.value, ch.value


class StreamBuffer:
    """PCM16 little-endian ingest buffer for one stream.

    The first chunk's 44-byte RIFF/WAVE header is stripped (across chunks
    if the first is shorter), an odd trailing byte waits for the next
    chunk, ``read`` returns every sample so far and ``clear`` empties the
    buffer (it does not re-arm the header strip, as in the JAX package)."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self._first = True
        self._skip = 0
        self._pending = b""

    def append(self, chunk: bytes) -> int:
        if self._first:
            if len(chunk) > 44 and chunk[:4] == b"RIFF" and chunk[8:12] == b"WAVE":
                self._skip = 44
            self._first = False
        if self._skip:
            cut = min(self._skip, len(chunk))
            chunk = chunk[cut:]
            self._skip -= cut
        data = self._pending + chunk
        self._pending = data[len(data) // 2 * 2 :]
        data = data[: len(data) // 2 * 2]
        if data:
            self._chunks.append(np.frombuffer(data, "<i2"))
        return self.size

    @property
    def size(self) -> int:
        return sum(len(c) for c in self._chunks)

    def read(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.int16)
        return np.concatenate(self._chunks)

    def clear(self) -> None:
        self._chunks = []
        self._pending = b""

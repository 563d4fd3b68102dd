"""Streaming PCM16 ingest: the JAX package's ``native.StreamBuffer`` in its
pure-Python form.

The JAX package backs the buffer with a C++ library when one is built and
falls back to a list of numpy chunks with the same semantics; the port
keeps the numpy form only (the rest of that module, the native WAV parser
and ring buffer, stays with the JAX package for now). The buffer lives on
the host: a streaming session reads it whole on every tick.
"""

from __future__ import annotations

import numpy as np


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

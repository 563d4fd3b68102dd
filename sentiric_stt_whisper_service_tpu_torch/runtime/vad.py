"""Voice-activity detection gate: a copy of the JAX package's
``runtime/vad.py``.

The reference service runs a Silero VAD model with threshold 0.75 and a
500 ms minimum speech duration. The builtin backend here, as in the JAX
package, is an adaptive energy/spectral VAD with the same gating
semantics: per-frame speech probability in [0,1], speech detected iff a
contiguous run of frames above ``threshold`` spans ``min_duration_ms``.
It is numpy on the host.

Install a model with ``set_vad_model(fn, frame_ms)`` where
``fn(audio) -> [n_frames] probs``; ``load_silero(path, device)`` installs
the Silero v5 network (``models/silero_vad.SileroVad``, on ``device``)
from a ggml-silero checkpoint.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

_vad_model: Optional[Callable[[np.ndarray], np.ndarray]] = None
_vad_frame_ms: float = 10.0


def set_vad_model(
    fn: Optional[Callable[[np.ndarray], np.ndarray]], frame_ms: float = 10.0
):
    """Install a custom VAD (None = builtin energy VAD). ``frame_ms`` is
    the duration of one element of the returned prob vector."""
    global _vad_model, _vad_frame_ms
    _vad_model = fn
    _vad_frame_ms = frame_ms if fn is not None else 10.0


def load_silero(path: str, device="auto") -> bool:
    """Install the Silero VAD from a ggml-silero checkpoint as the VAD
    backend, on ``device`` ("auto" / "cuda": the card, raising without one;
    "cpu": the plain versions). Returns True when it is installed, and
    False, leaving the VAD as it was, when the file is missing or cannot be
    parsed (``OSError``, ``ValueError``): the JAX package's fallback to the
    energy VAD. An error on the device propagates."""
    from ..models.silero_vad import SileroVad, load_silero_ggml
    from .engine import resolve_device

    try:
        tensors = load_silero_ggml(path)
    except (OSError, ValueError):
        return False
    model = SileroVad(tensors, resolve_device(device))
    set_vad_model(model, frame_ms=model.frame_ms)
    return True


def frame_speech_probs(audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """Per-frame speech probability (10 ms frames for the builtin VAD;
    the installed model's native frame size otherwise)."""
    if _vad_model is not None:
        return np.asarray(_vad_model(audio))
    return _energy_probs(audio, sample_rate)


def _energy_probs(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """Energy + spectral-shape speech probability per 10 ms frame."""
    shift = sample_rate // 100
    n_frames = len(audio) // shift
    if n_frames == 0:
        return np.zeros(0, np.float32)
    frames = audio[: n_frames * shift].reshape(n_frames, shift)
    rms = np.sqrt(np.mean(frames**2, axis=1))
    # Energy term on an absolute scale (float PCM in [-1,1]): -52 dBFS → 0,
    # -26 dBFS → 1. Absolute (not clip-adaptive) so an all-speech clip
    # doesn't raise its own floor.
    loud = np.clip((np.log10(rms + 1e-9) + 2.6) / 1.3, 0.0, 1.0)
    # Spectral tilt = mean |first difference| / rms. Voiced speech sits in
    # ~[0.02, 0.8]; mains hum is below, broadband noise ≈ 1.13 is above.
    diff = np.abs(np.diff(frames, axis=1)).mean(axis=1)
    tilt = diff / np.maximum(rms, 1e-8)
    tonal_band = np.clip((tilt - 0.01) * 25.0, 0.0, 1.0) * np.clip(
        (0.8 - tilt) * 4.0, 0.0, 1.0
    )
    return (loud * (0.25 + 0.75 * tonal_band)).astype(np.float32)


def is_speech_detected(
    audio: np.ndarray,
    sample_rate: int = 16000,
    threshold: float = 0.75,
    min_duration_ms: int = 500,
) -> bool:
    """True iff a contiguous run of frames above ``threshold`` spans
    ``min_duration_ms`` (dips up to ~100 ms are bridged — Silero /
    whisper.cpp min_silence_duration_ms semantics)."""
    probs = frame_speech_probs(np.asarray(audio, np.float32), sample_rate)
    if probs.size == 0:
        return False
    frame_ms = _vad_frame_ms if _vad_model is not None else 10.0
    active = probs > threshold
    need = max(1, int(round(min_duration_ms / frame_ms)))
    max_gap = max(1, int(round(100.0 / frame_ms)))
    run = 0
    gap = 0
    for a in active:
        if a:
            run += 1
            gap = 0
            if run >= need:
                return True
        else:
            gap += 1
            if gap > max_gap:
                run = 0
    return False

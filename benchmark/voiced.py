"""Speech-shaped audio that passes the port's energy VAD.

A frozen copy of ``voiced_like`` from ``chip_smoke.py`` (lines 1418-1431 at
the commit that added this benchmark), so that a later change to that
script cannot move the benchmark's inputs. Numbers and order of the random
draws are unchanged.
"""

from __future__ import annotations

import numpy as np


def voiced_like(rng, seconds: float, sr: int = 16000):
    """Harmonics of a gliding 110–195 Hz pitch under a 1.5 Hz syllable
    envelope with pauses, plus a little noise: passes the energy VAD."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110 + 60 * rng.uniform() + 25 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 16))
    env = np.clip(np.sin(2 * np.pi * 1.5 * t + rng.uniform(0, 6.28)) + 0.6, 0, 1)
    env *= np.sin(2 * np.pi * 0.2 * t + rng.uniform(0, 6.28)) > -0.6  # pauses
    x = x * env + 0.02 * rng.standard_normal(n)
    return (0.3 * x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def pcm16(x: np.ndarray) -> np.ndarray:
    """float audio in [-1, 1] → int16 PCM, as a caller sends it."""
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
